"""``python -m pmv_tpu_torch.tools.summit --dry-run`` on the CPU.

The sbatch script it writes holds every ``#SBATCH`` line of the JAX
package's ``tools/summit.py`` template (``--requeue``,
``--signal=USR1@120``, one task a node, the output file) for the same
arguments, and ``--gpus-per-node``; MASTER_ADDR from ``scontrol``. Its
``srun`` line runs ``python -m pmv_tpu_torch.tools.run_net``, and its
arguments, with the variables SLURM sets filled in, parse through the
port's ``run_net`` parser into a cfg of NUM_GPUS the cards a node,
OUTPUT_DIR, TRAIN.AUTO_RESUME True and the user's options, on shard
$SLURM_NODEID of ``--num-shards``, meeting at the first node.
"""

import os
import re
import shlex
import sys

from pmv_tpu_torch.config.parser import load_config, parse_args
from pmv_tpu_torch.tools import summit

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = os.path.join(ROOT, "configs", "Kinetics", "MVITv2_S_16x4.yaml")


def _jax_template():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import summit as jax_summit
    finally:
        sys.path.pop(0)
    return jax_summit.SBATCH_TEMPLATE


def test_dry_run_writes_a_script_run_net_parses(tmp_path, capsys):
    out = tmp_path / "runs"
    path = summit.main(["--cfg", CFG, "--name", "pmv", "--partition", "h100",
                        "--num-shards", "4", "--gpus-per-node", "8", "--port", "29411",
                        "--output-dir", str(out), "--dry-run",
                        "--opts", "SOLVER.MAX_EPOCH", "3", "TRAIN.BATCH_SIZE", "64"])
    script = open(path).read()
    assert path == os.path.join(str(out), "pmv.sbatch")
    assert script in capsys.readouterr().out  # printed, not submitted

    jax_lines = _jax_template().format(
        name="pmv", partition="h100", nodes=4, cpus=96, output_dir=os.path.abspath(out),
        port=29411, run_net="run_net.py", cfg=CFG, opts="", extra="").splitlines()
    for line in jax_lines:
        if line.startswith(("#SBATCH", "export MASTER")):
            assert line in script.splitlines(), line
    assert "#SBATCH --gpus-per-node=8" in script.splitlines()
    assert "#SBATCH --requeue" in script and "#SBATCH --signal=USR1@120" in script

    command = re.search(r"^srun python -m pmv_tpu_torch\.tools\.run_net (.*)", script,
                        re.S | re.M)[1]
    words = shlex.split(command.replace("\\\n", " "))
    filled = [w.replace("$SLURM_NODEID", "2").replace("$MASTER_ADDR", "node-a")
              .replace("$MASTER_PORT", "29411") for w in words]
    args = parse_args(filled)
    assert (args.num_shards, args.shard_id, args.init_method) == (4, 2, "tcp://node-a:29411")
    assert args.cfg_files == [os.path.abspath(CFG)]
    cfg = load_config(args, args.cfg_files[0])
    assert cfg.NUM_GPUS == 8 and cfg.NUM_SHARDS == 4 and cfg.SHARD_ID == 2
    assert cfg.OUTPUT_DIR == os.path.abspath(out) and cfg.TRAIN.AUTO_RESUME is True
    assert cfg.SOLVER.MAX_EPOCH == 3 and cfg.TRAIN.BATCH_SIZE == 64
    assert cfg.TPU.COORDINATOR_ADDRESS == "node-a:29411"
