#!/usr/bin/env python3
"""Drive the PyTorch port (pmv_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure raises and exits non-zero:

1. Print the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and build every CUDA kernel of the package from its sources.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the MViTv2-S 16x4 eval path gives it (batch 8, bfloat16 and
   float32) and at an odd portrait shape; time the kernel, the plain
   version and the one-call library equivalent with CUDA events.
3. Build full-width MViTv2-S 16x4 from a seeded init and run its eval step
   at batch 1 in float32 on the card and on the CPU (the CPU copy takes the
   plain versions); the class scores must agree, and one forward must
   launch the depthwise kernel 17 times.
4. Serve 4 synthetic videos x 2 temporal views x 3 spatial crops through
   the multi-view test loop in bfloat16 at batch 8 (the main path: launch
   counts are zeroed just before it and read just after).
5. Print the kernels line, the card line, and last
   {"ok": true, "device": {...}}.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

# H100 SXM data sheet: HBM rate, and the float32 rate outside the tensor
# cores (the depthwise kernel accumulates in float32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# (input shape at batch 8, launches per forward) of the stride-1 3x3x3
# pools of MViTv2-S 16x4 (C = heads * head_dim).
MVIT_POOL_SHAPES = [
    ((8, 8, 56, 56, 96), 1),    # q-pool, block 0
    ((8, 8, 28, 28, 192), 1),   # q-pool, block 2
    ((8, 8, 14, 14, 384), 10),  # q-pools, blocks 4-13
    ((8, 8, 14, 14, 768), 2),   # K and V pools, block 14
    ((8, 8, 7, 7, 768), 3),     # q, K and V pools, block 15
]
PORTRAIT_SHAPE = (2, 3, 13, 7, 24)
TOLERANCE = {  # (atol, rtol) against the plain version in float32
    torch.float32: (1e-5, 1e-5),
    torch.bfloat16: (1e-2, 8e-3),  # one bfloat16 rounding of the output
}


def log(msg):
    print(msg, flush=True)


def depthwise_bound(shape, dtype):
    """Least time (ms) of one stride-1 3x3x3 depthwise conv: bytes (x and w
    read once, out written once) over HBM rate, or 27 FMAs per output over
    the float32 rate, whichever is larger."""
    elems = int(np.prod(shape))
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * elems + 27 * shape[-1]) * size
    ops = 54 * elems
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(flush):
    import torch.nn.functional as F

    from pmv_tpu_torch.ops.depthwise import depthwise3x3x3, depthwise3x3x3_plain
    from pmv_tpu_torch.tools.timing import time_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    cases = [(s, n) for s, n in MVIT_POOL_SHAPES] + [(PORTRAIT_SHAPE, 0)]
    for shape, per_forward in cases:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (0.1 * torch.randn((3, 3, 3, shape[-1]), generator=gen,
                                   device="cuda")).to(dtype)
            out = depthwise3x3x3(x, w)
            torch.cuda.synchronize()
            ref = depthwise3x3x3_plain(x.float(), w.float())
            atol, rtol = TOLERANCE[dtype]
            torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)
            err = float((out.float() - ref).abs().max())
            c = shape[-1]
            x_ncdhw = x.permute(0, 4, 1, 2, 3).contiguous()
            w_conv = w.permute(3, 0, 1, 2).reshape(c, 1, 3, 3, 3).contiguous()
            bound_ms, bound_by = depthwise_bound(shape, dtype)
            rec = {
                "kernel": "depthwise3x3x3",
                "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "launches_per_forward": per_forward,
                "max_abs_err": err,
                "kernel_ms": time_ms(lambda: depthwise3x3x3(x, w), flush=flush),
                "plain_ms": time_ms(lambda: depthwise3x3x3_plain(x, w), flush=flush),
                "library_ms": time_ms(
                    lambda: F.conv3d(x_ncdhw, w_conv, padding=1, groups=c),
                    flush=flush,
                ),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            log(json.dumps(rec))
            records.append(rec)
    return records


def phase_full_model(frames):
    from pmv_tpu_torch.engine.steps import make_eval_step
    from pmv_tpu_torch.entry import mvitv2_s_cfg
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.ops.depthwise import depthwise3x3x3

    cfg = mvitv2_s_cfg()
    cpu_model = build_model(cfg, device="cpu", dtype=torch.float32, seed=0)
    gpu_model = build_model(cfg, device="cuda", dtype=torch.float32, seed=0)
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    n_params = sum(p.numel() for p in gpu_model.parameters())

    before = depthwise3x3x3.launches
    t0 = time.perf_counter()
    gpu = make_eval_step(cfg, gpu_model, device="cuda")(frames).cpu()
    gpu_s = time.perf_counter() - t0
    launches = depthwise3x3x3.launches - before
    t0 = time.perf_counter()
    cpu = make_eval_step(cfg, cpu_model, device="cpu")(frames)
    cpu_s = time.perf_counter() - t0
    err = float((gpu - cpu).abs().max())
    log(json.dumps({
        "phase": "full_model_f32_b1", "params": n_params,
        "depthwise_launches": launches, "max_abs_err_vs_cpu": err,
        "gpu_first_call_s": gpu_s, "cpu_s": cpu_s,
    }))
    if launches != 17:
        raise AssertionError(f"one forward launched the kernel {launches} times, not 17")
    if not torch.isfinite(gpu).all():
        raise AssertionError("non-finite class scores on the card")
    torch.testing.assert_close(gpu, cpu, atol=1e-4, rtol=0)


def phase_serve(card):
    from pmv_tpu_torch.engine.steps import make_eval_step
    from pmv_tpu_torch.engine.test import perform_test
    from pmv_tpu_torch.entry import mvitv2_s_cfg
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.ops.depthwise import depthwise3x3x3
    from pmv_tpu_torch.utils.meters import TestMeter

    cfg = mvitv2_s_cfg()
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    cfg.TEST.NUM_SPATIAL_CROPS = 3
    num_videos, batch = 4, 8
    num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    model = build_model(cfg, device="cuda", seed=0)  # bfloat16 activations
    eval_step = make_eval_step(cfg, model, device="cuda")

    rng = np.random.default_rng(0)
    n = num_videos * num_clips
    size = cfg.DATA.TEST_CROP_SIZE
    clips = rng.integers(0, 256, (n, cfg.DATA.NUM_FRAMES, size, size, 3), np.uint8)
    labels = rng.integers(0, cfg.MODEL.NUM_CLASSES, num_videos)
    loader = [
        {"frames": clips[i:i + batch], "index": np.arange(i, min(i + batch, n)),
         "labels": labels[np.arange(i, min(i + batch, n)) // num_clips]}
        for i in range(0, n, batch)
    ]
    eval_step(loader[0]["frames"])  # warm-up: cuDNN and cuBLAS plans
    torch.cuda.synchronize()

    outputs = []

    def serving_step(frames):
        preds = eval_step(frames)
        outputs.append(preds)
        return preds

    meter = TestMeter(num_videos, num_clips, cfg.MODEL.NUM_CLASSES, len(loader))
    torch.cuda.reset_peak_memory_stats()
    depthwise3x3x3.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    meter, stats = perform_test(loader, serving_step, meter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"depthwise3x3x3": depthwise3x3x3.launches}  # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    preds = torch.cat(outputs).float().cpu()
    if preds.shape != (n, cfg.MODEL.NUM_CLASSES) or not torch.isfinite(preds).all():
        raise AssertionError(f"bad class scores: shape {tuple(preds.shape)}")
    torch.testing.assert_close(preds.sum(dim=1), torch.ones(n), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(meter.clip_count, [num_clips] * num_videos)
    np.testing.assert_allclose(meter.video_preds.sum(axis=1), num_clips, atol=1e-2)
    if launches["depthwise3x3x3"] != 17 * len(loader):
        raise AssertionError(f"serving launched {launches} kernels, not 17 per batch")
    log(json.dumps({
        "phase": "serve_bf16_b8", "card": card, "videos": num_videos,
        "clips": n, "batches": len(loader), "wall_s": wall,
        "clips_per_s": n / wall, "ms_per_batch": wall / len(loader) * 1e3,
        "max_memory_allocated_bytes": peak, "launches": launches,
        "stats": stats,
    }))
    return launches


def kernels_line(records, launches):
    """One entry per kernel: times summed over the launches of one batch-8
    bfloat16 forward at the main path's shapes."""
    main = [r for r in records if r["dtype"] == "bfloat16" and r["launches_per_forward"]]

    def per_forward(key):
        return sum(r[key] * r["launches_per_forward"] for r in main)

    kernel_ms = per_forward("kernel_ms")
    return {"kernels": [{
        "name": "depthwise3x3x3",
        "route": "cuda",
        "source": "pmv_tpu_torch/ops/csrc/depthwise3x3x3.cu",
        "replaces": "pmv_tpu/ops/depthwise_pallas.py:77",
        "launches": launches["depthwise3x3x3"],
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main) else "operations",
        "library_ms": per_forward("library_ms"),
    }]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every record to this JSON file")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pmv_tpu_torch.ops import build as kernel_build
    from pmv_tpu_torch.tools.timing import card_line

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(os.cpu_count() or 1)

    # Phase 1: the card, and the kernel build.
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    build_s = kernel_build.build_kernels()
    log(json.dumps({"phase": "build", "seconds": build_s}))
    for stem, output in kernel_build.build_log.items():
        log(f"nvcc {stem}.cu:\n{output.strip()}")

    # Phase 2: every kernel against its plain version.
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    records = phase_kernels(flush)
    del flush

    # Phase 3: the full model on the card and on the CPU.
    frames = np.random.default_rng(1).integers(0, 256, (1, 16, 224, 224, 3), np.uint8)
    phase_full_model(frames)

    # Phase 4: the main path.
    launches = phase_serve(card)

    line = kernels_line(records, launches)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "records": records, **line}, f, indent=1)
    log(json.dumps(line))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
