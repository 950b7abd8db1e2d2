"""Where the float32 gradients of the MaskFeat train step part from float64's,
op by op, on the CPU and on the card.

MaskMViT of the PT yaml at a seeded random init; for each seed a batch, the
step's draws (the model's mask) and the CPU's HOG bins, all from that seed:
one masked train step (``engine/ssl_steps.py``, the AdamW step of
``chip_smoke.py``'s phase 3m) in float64 activations on the CPU, the
reference, then in float32 on the CPU and on the card: first as each run
decides its max pools itself (the skip pools of blocks 1 and 3), then with
every max pool taking the float64 run's taps (``grad_witness.
max_pool_decisions``), with the count of outputs whose own maximum lies at
another tap. For each it prints the relative L2 distance of the gradients
from float64's, over all and for the tensors that add most to it.

With ``--ops`` (on the first seed) every module of the float64 step that
computes (each Linear, conv, LayerNorm, attention pool, MLP, attention,
block, the patch embedding and the prediction head) runs again alone, on
its own float64 input and output gradient: in float64 on the CPU (the
reference), and on those rounded to float32, in float32 on the CPU and on
the card. For each it prints the relative L2 distance of its input
gradient and of its weights' gradients from float64's, summed by module
type and for the modules the furthest off. An op whose CPU distance stands
above the card's on the same rounded inputs is where the CPU's float32
arithmetic loses more than the card's; where both stand alike, it is
float32's own rounding of that op.

    python -m pmv_tpu_torch.tools.op_witness [--cfg <PT yaml>] [--seeds 7 8 9]
        [--ops] [--cpu-only] [--out FILE]

Batch 2, as phase 3m. Without ``--cpu-only`` it needs a CUDA device. The
full-size step in float64 on the CPU takes tens of GiB with ``--ops``: run
it on the GPU machine, or on ``configs/tiny_maskfeat_synthetic.yaml``.
"""

import argparse
import collections
import copy
import json
import sys
import time

import numpy as np
import torch
from torch import nn

from pmv_tpu_torch.tools.grad_witness import distance, load_cfg, max_pool_decisions, norm

MASKFEAT_PT = "configs/masked_ssl/k400_MVITv2_S_16x4_MaskFeat_PT.yaml"
BATCH = 2
TOP = 8  # tensors and modules listed, furthest off first


def _types():
    from pmv_tpu_torch.models.attention import (
        AttentionPool,
        MultiScaleAttention,
        MultiScaleBlock,
    )
    from pmv_tpu_torch.models.common import ChannelsLastConv3d, LayerNorm, Linear, Mlp
    from pmv_tpu_torch.models.masked import MSSeparateHead
    from pmv_tpu_torch.models.mvit import PatchEmbed

    return (Linear, ChannelsLastConv3d, LayerNorm, AttentionPool, Mlp, MultiScaleAttention,
            MultiScaleBlock, PatchEmbed, MSSeparateHead)


def _first_tensor(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def record_ops(model):
    """Forward hooks on every module of ``_types()``: each call's module,
    arguments and output, and (filled in by the backward) the gradient of
    its output. Returns (records, hook handles)."""
    records, handles = [], []
    types = _types()

    def hook(module, args, kwargs, out):
        rec = {"name": names[module], "module": module, "args": args, "kwargs": kwargs}
        y = _first_tensor(out)
        if y.requires_grad:
            y.register_hook(lambda g: rec.__setitem__("dy", g.detach()))
            records.append(rec)

    names = {m: n for n, m in model.named_modules() if isinstance(m, types)}
    for module in names:
        handles.append(module.register_forward_hook(hook, with_kwargs=True))
    return records, handles


def _moved(value, device, dtype):
    """``value`` on ``device``: floating tensors in ``dtype``, modules
    copied there, containers element by element, anything else as is."""
    if isinstance(value, torch.Tensor):
        value = value.detach().to(device)
        return value.to(dtype) if value.is_floating_point() else value
    if isinstance(value, nn.Module):
        return copy.deepcopy(value).to(device)
    if isinstance(value, (tuple, list)):
        return type(value)(_moved(v, device, dtype) for v in value)
    return value


def replay(rec, device, dtype):
    """The recorded call again alone, on ``device`` in ``dtype``: the
    gradients of its first input and of its parameters (float64, on the
    CPU) for the recorded output gradient."""
    module = copy.deepcopy(rec["module"]).to(device)
    x = _moved(rec["args"][0], device, dtype).requires_grad_()
    rest = _moved(rec["args"][1:], device, dtype)
    kwargs = {k: _moved(v, device, dtype) for k, v in rec["kwargs"].items()}
    y = _first_tensor(module(x, *rest, **kwargs))
    params = dict(module.named_parameters())
    grads = torch.autograd.grad(y, [x, *params.values()], rec["dy"].to(device, y.dtype),
                                allow_unused=True)
    out = {"dx": grads[0]}
    out.update({k: g for k, g in zip(params, grads[1:]) if g is not None})
    return {k: v.detach().double().cpu() for k, v in out.items()}


def op_distances(records, devices):
    """Per recorded call, the relative L2 distance of its input gradient
    ("dx") and of its parameters' gradients ("dw", all together) in float32
    on each of ``devices`` from float64's on the CPU."""
    rows = []
    for rec in records:
        ref = replay(rec, "cpu", torch.float64)
        row = {"name": rec["name"], "type": type(rec["module"]).__name__,
               "x": list(rec["args"][0].shape)}
        for device in devices:
            got = replay(rec, device, torch.float32)
            row[f"{device}_dx"] = distance({"dx": got["dx"]}, {"dx": ref["dx"]})
            ws = {k: v for k, v in ref.items() if k != "dx"}
            if ws:
                row[f"{device}_dw"] = distance(got, ws)
        rows.append(row)
    return rows


def by_type(rows, devices):
    """Per module type, the largest distance of each reading."""
    out = collections.defaultdict(dict)
    for row in rows:
        for key in (f"{d}_{g}" for d in devices for g in ("dx", "dw")):
            if key in row:
                out[row["type"]][key] = max(out[row["type"]].get(key, 0.0), row[key])
    return dict(out)


def furthest(grads, ref, top=TOP):
    """The ``top`` tensors that add most to the distance of ``grads`` from
    ``ref``: each one's L2 difference over the whole reference's norm (its
    share of ``distance``), and over its own gradient's norm."""
    total = sum(float(v.square().sum()) for v in ref.values()) ** 0.5
    diffs = sorted(((float((grads[k] - v).norm()), k) for k, v in ref.items()), reverse=True)
    return [{"param": k, "l2_over_total": d / total,
             "rel_l2": d / max(float(ref[k].norm()), 1e-300)} for d, k in diffs[:top]]


def masked_step(cfg, state_dict, batch, draws, device, dtype, record=False, decisions=None):
    """One masked train step of the model holding ``state_dict`` in ``dtype``
    on ``device``, its max pools taking ``decisions`` where given: ({name:
    gradient, float64 on the CPU}, loss, grad norm, records of
    ``record_ops`` or None, the step's max-pool ``Decisions``)."""
    from pmv_tpu_torch.engine.ssl_steps import init_masked_state, make_masked_train_step
    from pmv_tpu_torch.models import build_model

    model = build_model(cfg, device=device, dtype=dtype, seed=0)
    model.load_state_dict(state_dict, strict=True)
    records, handles = record_ops(model) if record else (None, [])
    step = make_masked_train_step(cfg, device=device, seed=0)
    with max_pool_decisions(decisions) as taken:
        m = step(init_masked_state(cfg, model), batch, cfg.SOLVER.BASE_LR, draws)
    for h in handles:
        h.remove()
    grads = {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}
    return grads, float(m["loss"]), float(m["grad_norm"]), records, taken


def seed_inputs(cfg, batch_size, seed):
    """The seeded init's state_dict, a batch of uint8 clips, and the step's
    draws (the model's mask) with the CPU's float32 HOG bins, from ``seed``."""
    from pmv_tpu_torch.engine.ssl_steps import make_masked_train_step
    from pmv_tpu_torch.engine.steps import make_preprocess_fn
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.models.masked import hog_bins

    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=seed)
    s = cfg.DATA.TRAIN_CROP_SIZE
    rng = np.random.default_rng(seed)
    batch = {"frames": rng.integers(0, 256, (batch_size, cfg.DATA.NUM_FRAMES, s, s, 3),
                                    np.uint8)}
    draws = make_masked_train_step(cfg, device="cpu", seed=seed).sample_draws(
        model, batch["frames"].shape)
    x = make_preprocess_fn(cfg, train=True, device="cpu")(torch.as_tensor(batch["frames"]),
                                                          draws)
    draws["hog_bins"] = hog_bins(x)
    return model.state_dict(), batch, draws


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cfg", default=MASKFEAT_PT)
    parser.add_argument("--seeds", type=int, nargs="+", default=[7, 8, 9])
    parser.add_argument("--ops", action="store_true",
                        help="also replay every module alone (on the first seed)")
    parser.add_argument("--cpu-only", action="store_true", help="leave the card out")
    parser.add_argument("--out", help="also write the JSON lines here")
    args = parser.parse_args(argv)
    if not args.cpu_only and not torch.cuda.is_available():
        print("op_witness: no CUDA device (or --cpu-only)", file=sys.stderr)
        return 1
    cfg = load_cfg(args.cfg, ["NUM_GPUS", "1"])
    devices = ["cpu"] if args.cpu_only else ["cpu", "cuda"]
    if not args.cpu_only:
        from pmv_tpu_torch.tools.timing import card_line

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        card = card_line()
    lines = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        state_dict, batch, draws = seed_inputs(cfg, BATCH, seed)
        ops = args.ops and i == 0
        ref, loss, gnorm, records, ref_decisions = masked_step(
            cfg, state_dict, batch, draws, "cpu", torch.float64, record=ops)
        rec = {"seed": seed, "model": cfg.MODEL.MODEL_NAME, "batch": BATCH,
               "frames": cfg.DATA.NUM_FRAMES, "crop": cfg.DATA.TRAIN_CROP_SIZE,
               "f64_loss": loss, "f64_grad_norm": gnorm,
               "max_pool_outputs": sum(int(m.numel()) for m in ref_decisions.masks)}
        if not args.cpu_only:
            rec["card"] = card
        for device in devices:
            for held in (None, ref_decisions):
                grads, loss, gnorm, _, taken = masked_step(cfg, state_dict, batch, draws,
                                                           device, torch.float32,
                                                           decisions=held)
                key = f"{device}_f32" + ("_f64_decisions" if held else "")
                rec[key] = {
                    "grad_rel_l2_vs_f64": distance(grads, ref),
                    "grad_norm_rel_vs_f64": gnorm / rec["f64_grad_norm"] - 1,
                    # The norm of the same gradients taken in float64: what
                    # the step's own float32 norm adds to the distance.
                    "grad_norm_in_f64_rel_vs_f64": norm(grads) / rec["f64_grad_norm"] - 1,
                    "loss_rel_vs_f64": loss / rec["f64_loss"] - 1,
                    "furthest": furthest(grads, ref),
                }
                if held:
                    rec[key]["decisions_taken_otherwise"] = taken.taken_otherwise
        if ops:
            rows = op_distances(records, devices)
            del records
            rec["ops_by_type"] = by_type(rows, devices)
            for device in devices:
                key = f"{device}_dw"
                rec[f"ops_furthest_{key}"] = sorted(
                    (r for r in rows if key in r), key=lambda r: -r[key])[:TOP]
            if len(devices) == 2:
                rec["ops_cpu_over_card_dw"] = sorted(
                    (r for r in rows if "cpu_dw" in r),
                    key=lambda r: -r["cpu_dw"] / max(r["cuda_dw"], 1e-300))[:TOP]
        rec["seconds"] = time.perf_counter() - t0
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
