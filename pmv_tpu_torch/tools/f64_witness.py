"""Where a contrastive step in float64 activations parts between the card and
the CPU, op by op.

For each contrastive yaml (configs/contrastive_ssl/: MoCo, SimCLR, BYOL,
SwAV on Slow 8x8 R50), at full width from one seeded init, with a queue and
a bank of seeded unit rows, one step at batch 2 (2 views a video) in float64
activations on the CPU and on the card from the same weights and draws, as
``chip_smoke.py``'s phase 3c runs it. Every leaf module's output is
recorded in call order on both sides (the momentum encoder's key forward,
in eval mode, among them), and the script prints, per step, the first call
whose output differs by more than ``--limit`` (relative to its largest
value), the calls the furthest apart, summed by module type, and the
gradients' and the weights' updates' relative L2 distance. Then, on the CPU
step's own gradients and weights, the per-tensor L2 norms that the
optimizer takes (the global grad norm, LARS's trust ratio ||p|| / ||u||) in
float32 on the CPU and on the card against float64: the largest relative
distance of each.

    python -m pmv_tpu_torch.tools.f64_witness [--yamls moco simclr byol swav]
        [--frames F] [--crop S] [--out FILE]

Needs a CUDA device. The full-size float64 step on the CPU takes some GiB
and tens of seconds a yaml: run it on the GPU machine, or at a small
``--frames`` and ``--crop``.
"""

import argparse
import collections
import json
import os
import sys

import numpy as np
import torch

from pmv_tpu_torch.tools.grad_witness import distance, load_cfg

YAMLS = {"moco": "MoCo_SlowR50_8x8.yaml", "simclr": "SimCLR_SlowR50_8x8.yaml",
         "byol": "BYOL_SlowR50_8x8.yaml", "swav": "SwAV_Slow_R50_8x8.yaml"}
TOP = 6


def _models(cfg, dtype):
    """The model on the CPU and on the card from one seeded init, the queue
    and the bank filled with seeded unit rows."""
    from pmv_tpu_torch.models import build_model

    cpu = build_model(cfg, device="cpu", dtype=dtype, seed=0)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name in ("queue", "bank"):
            if hasattr(cpu, name):
                t = getattr(cpu, name)
                t.copy_(torch.nn.functional.normalize(torch.randn(t.shape, generator=gen), dim=1))
    gpu = build_model(cfg, device="cuda", dtype=dtype, seed=0)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    return cpu, gpu


def _recorded(model):
    """Forward hooks on every leaf module: [(name, type, output on the
    CPU)] in call order, and the hooks' handles."""
    calls, names = [], {m: n for n, m in model.named_modules()}

    def hook(module, args, out):
        out = out[0] if isinstance(out, (tuple, list)) else out
        if torch.is_tensor(out):
            calls.append((names[module], type(module).__name__, out.detach().cpu()))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if not any(True for _ in m.children())]
    return calls, handles


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / max(float(b.double().abs().max()), 1e-300))


def step_witness(cfg, batch, limit):
    """One float64 step on both sides; the readings as a dict."""
    from pmv_tpu_torch.engine.ssl_steps import init_ssl_state, make_ssl_train_step

    cpu_model, gpu_model = _models(cfg, torch.float64)
    before = {k: v.detach().clone() for k, v in cpu_model.named_parameters()}
    cpu_step = make_ssl_train_step(cfg, device="cpu", seed=0)
    gpu_step = make_ssl_train_step(cfg, device="cuda", seed=0)
    draws = cpu_step.sample_draws(batch["frames"].shape[:1] + batch["frames"].shape[2:])
    lr = cfg.SOLVER.BASE_LR
    sides = {}
    for side, model, step in (("cpu", cpu_model, cpu_step), ("card", gpu_model, gpu_step)):
        calls, handles = _recorded(model)
        metrics = step(init_ssl_state(cfg, model), batch, lr, draws)
        for h in handles:
            h.remove()
        sides[side] = (calls, {k: float(v) for k, v in metrics.items()})
    (cpu_calls, cpu_m), (gpu_calls, gpu_m) = sides["cpu"], sides["card"]
    assert [c[:2] for c in cpu_calls] == [c[:2] for c in gpu_calls], "the call orders differ"
    rows = [(_rel(g[2], c[2]), i, c[0], c[1]) for i, (c, g) in enumerate(zip(cpu_calls, gpu_calls))]
    first = next(((i, name, kind, d) for d, i, name, kind in rows if d > limit), None)
    types = collections.defaultdict(float)
    for d, _, _, kind in rows:
        types[kind] = max(types[kind], d)
    grads = {k: p.grad.detach().double().cpu() for k, p in gpu_model.named_parameters()}
    ref = {k: p.grad.detach().double() for k, p in cpu_model.named_parameters()}
    upd = {k: p.detach().double().cpu() - before[k].double()
           for k, p in gpu_model.named_parameters()}
    upd_ref = {k: p.detach().double() - before[k].double()
               for k, p in cpu_model.named_parameters()}
    return {
        "type": cfg.CONTRASTIVE.TYPE, "calls": len(rows),
        "first_over_limit": None if first is None else
        {"call": first[0], "module": first[1], "kind": first[2], "rel_err": first[3]},
        "furthest": [{"call": i, "module": n, "kind": k, "rel_err": d}
                     for d, i, n, k in sorted(rows, reverse=True)[:TOP]],
        "max_rel_err_by_kind": dict(sorted(types.items(), key=lambda kv: -kv[1])),
        "loss": [gpu_m["loss"], cpu_m["loss"]],
        "grad_norm": [gpu_m["grad_norm"], cpu_m["grad_norm"]],
        "grad_rel_err": distance(grads, ref), "update_rel_err": distance(upd, upd_ref),
    }, cpu_model, before


def norm_witness(model, before):
    """The optimizer's per-tensor norms of ``model``'s gradients and of its
    weights before the step, float32 on the CPU and on the card, against
    float64: the largest relative distance of each."""
    out = {}
    for what, tensors in (("grad", [p.grad.detach() for p in model.parameters()]),
                          ("param", list(before.values()))):
        ref = [torch.linalg.vector_norm(t.double()) for t in tensors]
        for side, device in (("cpu", "cpu"), ("card", "cuda")):
            got = [torch.linalg.vector_norm(t.float().to(device)).double().cpu() for t in tensors]
            out[f"{what}_norm_f32_{side}_vs_f64"] = max(
                float((g - r).abs() / max(float(r), 1e-300)) for g, r in zip(got, ref))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--yamls", nargs="+", default=list(YAMLS), choices=list(YAMLS))
    parser.add_argument("--frames", type=int, help="DATA.NUM_FRAMES (the yaml's by default)")
    parser.add_argument("--crop", type=int, help="DATA.TRAIN_CROP_SIZE (the yaml's by default)")
    parser.add_argument("--limit", type=float, default=1e-12,
                        help="the relative distance an output may part by")
    parser.add_argument("--out", help="also write the JSON lines here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("f64_witness: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    lines = []
    for name in args.yamls:
        opts = ["NUM_GPUS", "1"]
        if args.frames:
            opts += ["DATA.NUM_FRAMES", str(args.frames)]
        if args.crop:
            opts += ["DATA.TRAIN_CROP_SIZE", str(args.crop)]
        cfg = load_cfg(os.path.join("configs", "contrastive_ssl", YAMLS[name]), opts)
        rng = np.random.default_rng(3)
        size = cfg.DATA.TRAIN_CROP_SIZE
        batch = {"frames": rng.integers(0, 256, (2, 2, cfg.DATA.NUM_FRAMES, size, size, 3),
                                        np.uint8),
                 "index": np.arange(2, dtype=np.int64) * 1000 + 7}
        rec, cpu_model, before = step_witness(cfg, batch, args.limit)
        rec.update(norm_witness(cpu_model, before))
        line = json.dumps({"yaml": YAMLS[name], **rec})
        print(line, flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
