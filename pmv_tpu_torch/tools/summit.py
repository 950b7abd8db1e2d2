"""SLURM cluster launcher (`Uniformer/tools/summit.py:81-203`; the JAX
package's `tools/summit.py`).

    python -m pmv_tpu_torch.tools.summit --cfg configs/... --partition my-part \\
        --num-shards 4 --gpus-per-node 8 [--dry-run] [--opts KEY VALUE ...]

The reference uses submitit; this writes an sbatch script and submits it
(``--dry-run``: writes and prints it, and submits nothing). The job holds
``--num-shards`` nodes, one task a node: ``srun`` starts
``python -m pmv_tpu_torch.tools.run_net`` once on each node, with
``--num_shards``, ``--shard_id $SLURM_NODEID`` and ``--init_method`` at the
first node, and that process's ``launch_job`` starts NUM_GPUS processes,
one a card; so the script asks for ``--gpus-per-node`` cards a node and
passes NUM_GPUS of as many.

Preemption is lossless through the requeue and auto-resume alone: the job
is ``--requeue``d, and ``TRAIN.AUTO_RESUME True`` restores the last
checkpoint of OUTPUT_DIR (``utils/checkpoint.py``). ``--signal=USR1@120``
is kept from the reference's template, but nothing handles USR1 in
``run_net``, as in the JAX package's: the epochs since the last checkpoint
are trained again.
"""

import argparse
import os
import subprocess

SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --partition={partition}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node=1
#SBATCH --gpus-per-node={gpus}
#SBATCH --cpus-per-task={cpus}
#SBATCH --output={output_dir}/slurm-%j.out
#SBATCH --signal=USR1@120
#SBATCH --requeue
{extra}

export MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)
export MASTER_PORT={port}

cd {root}
srun python -m pmv_tpu_torch.tools.run_net \\
  --cfg {cfg} \\
  --num_shards {nodes} \\
  --shard_id $SLURM_NODEID \\
  --init_method tcp://$MASTER_ADDR:$MASTER_PORT \\
  --opts NUM_GPUS {gpus} OUTPUT_DIR {output_dir} TRAIN.AUTO_RESUME True {opts}
"""

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--name", default="pmv_tpu_torch")
    ap.add_argument("--partition", default="gpu")
    ap.add_argument("--num-shards", type=int, default=1, help="nodes")
    ap.add_argument("--gpus-per-node", type=int, default=8,
                    help="cards a node, and NUM_GPUS: run_net's processes a node")
    ap.add_argument("--cpus", type=int, default=96)
    ap.add_argument("--port", type=int, default=28999)
    ap.add_argument("--output-dir", default="./slurm_runs")
    ap.add_argument("--extra-sbatch", default="")
    ap.add_argument("--dry-run", action="store_true")
    # The JAX tool's overrides are a bare REMAINDER, which argparse refuses
    # to start at "--opts" (its docstring's usage); here both forms work.
    ap.add_argument("--opts", dest="flag_opts", default=[], nargs=argparse.REMAINDER,
                    help="run_net's config overrides: KEY VALUE pairs")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                    help="run_net's config overrides, without --opts")
    args = ap.parse_args(argv)
    args.opts = list(args.opts) + list(args.flag_opts)
    return args


def sbatch_script(args):
    """The sbatch script of ``args``."""
    return SBATCH_TEMPLATE.format(
        name=args.name,
        partition=args.partition,
        nodes=args.num_shards,
        gpus=args.gpus_per_node,
        cpus=args.cpus,
        output_dir=os.path.abspath(args.output_dir),
        port=args.port,
        root=ROOT,
        cfg=os.path.abspath(args.cfg),
        opts=" ".join(args.opts),
        extra=args.extra_sbatch,
    )


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    script = sbatch_script(args)
    path = os.path.join(args.output_dir, f"{args.name}.sbatch")
    with open(path, "w") as f:
        f.write(script)
    print(f"sbatch script written to {path}")
    if args.dry_run:
        print(script)
        return path
    subprocess.run(["sbatch", path], check=True)
    return path


if __name__ == "__main__":
    main()
