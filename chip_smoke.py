#!/usr/bin/env python3
"""Drive the PyTorch port (pmv_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure raises and exits non-zero:

1. Print the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and build every CUDA kernel of the package from its sources.
   nvcc's ptxas report must show no spills.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the MViTv2-S 16x4 path gives it (batch 8, bfloat16 and float32)
   and at odd shapes (C of 8, 24 and 40, H and W of 1, 2, 7 and 13, portrait
   grids, T of 1 to 3, B of 1); time the kernel cold (L2 flushed) and warm,
   the plain version and the one-call library equivalent with CUDA events.
   The forward kernel K1 (``depthwise3x3x3``), then the backward through
   the autograd Function: dx through K1 and dw through
   ``depthwise3x3x3_wgrad``; two runs of the wgrad kernel give the same
   bits.
3. Build full-width MViTv2-S 16x4 from a seeded init and run its eval step
   at batch 1 in float32 on the card and on the CPU (the CPU copy takes the
   plain versions); the class scores must agree, and one forward must
   launch the depthwise kernel 17 times.
3b. One train step of full-width MViTv2-S 16x4 (the bench recipe:
   RandAugment, erasing, MixUp/CutMix, DropPath, head dropout, AdamW with
   clipping) in float32 at batch 2 on the card and on the CPU, from the
   same weights and the same draws: loss, grad norm, top-1/top-5, the
   gradients and the updated parameters must agree, and the step must
   launch K1 34 times and the wgrad kernel 17 times.
4. Serve 4 synthetic videos x 2 temporal views x 3 spatial crops through
   the multi-view test loop in bfloat16 at batch 8 (a main path: launch
   counts are zeroed just before it and read just after).
5. Train: ``train_epoch`` over 1 warm-up and then 5 timed synthetic batches
   of 8 clips [16, 224, 224, 3] uint8, bfloat16 activations, AdamW, LR 1e-4
   (the slice's main path: counts zeroed just before the 5 batches and read
   just after; 34 K1 and 17 wgrad launches per step).
6. Print the kernels line, the card line, and last
   {"ok": true, "device": {...}}.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

import argparse
import json
import os
import re
import sys
import time

import numpy as np
import torch

# H100 SXM data sheet: HBM rate, and the float32 rate outside the tensor
# cores (the depthwise kernel accumulates in float32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

TOLERANCE = {  # (atol, rtol) against the plain version in float32
    torch.float32: (1e-5, 1e-5),
    torch.bfloat16: (1e-2, 8e-3),  # one bfloat16 rounding of the output
}
# dw sums up to B*T*H*W = 200,704 products of N(0, 1) values (of order
# sqrt(200,704) ~ 450) in another order than the plain version's float32
# sums; in bfloat16, one rounding of the output besides.
WGRAD_TOLERANCE = {
    torch.float32: (2e-3, 1e-5),
    torch.bfloat16: (1e-2, 8e-3),
}
TRAIN_LR = 1e-4  # bench.py's learning rate


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


def wgrad_bound(shape, dtype):
    """Least time (ms) of one depthwise weight gradient: bytes (x and g read
    once, 27 * C float32 written) over HBM rate, or 27 FMAs per input
    element over the float32 rate, whichever is larger."""
    elems = int(np.prod(shape))
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * elems * size + 27 * shape[-1] * 4
    ops = 54 * elems
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _kernel_cases():
    """(shape, launches per forward): the MViTv2-S 16x4 pool shapes at batch
    8, then the odd shapes (no launches on the main path)."""
    from pmv_tpu_torch.ops.depthwise import MVIT_POOL_SHAPES, ODD_SHAPES

    return list(MVIT_POOL_SHAPES) + [(s, 0) for s in ODD_SHAPES]


def phase_kernels(flush):
    import torch.nn.functional as F

    from pmv_tpu_torch.ops.depthwise import depthwise3x3x3, depthwise3x3x3_plain
    from pmv_tpu_torch.tools.timing import time_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for shape, per_forward in _kernel_cases():
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
                "kernel_warm_ms": time_ms(lambda: depthwise3x3x3(x, w)),
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


def phase_backward(flush):
    """The autograd Function's dx (K1 on the cotangent, weights flipped) and
    dw (the wgrad kernel) against the plain versions in float32."""
    from pmv_tpu_torch.ops.depthwise import (
        depthwise3x3x3,
        depthwise3x3x3_plain,
        depthwise3x3x3_wgrad,
        depthwise3x3x3_wgrad_plain,
    )
    from pmv_tpu_torch.tools.timing import time_ms

    gen = torch.Generator(device="cuda").manual_seed(1)
    records = []
    for shape, per_forward in _kernel_cases():
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (0.1 * torch.randn((3, 3, 3, shape[-1]), generator=gen,
                                   device="cuda")).to(dtype)
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            depthwise3x3x3(xg, wg).backward(g)
            torch.cuda.synchronize()
            dx_ref = depthwise3x3x3_plain(g.float(), w.float().flip(0, 1, 2))
            dw_ref = depthwise3x3x3_wgrad_plain(x.float(), g.float())
            atol, rtol = TOLERANCE[dtype]
            torch.testing.assert_close(xg.grad.float(), dx_ref, atol=atol, rtol=rtol)
            atol, rtol = WGRAD_TOLERANCE[dtype]
            torch.testing.assert_close(wg.grad.float(), dw_ref, atol=atol, rtol=rtol)
            if not torch.equal(depthwise3x3x3_wgrad(x, g), depthwise3x3x3_wgrad(x, g)):
                raise AssertionError("the wgrad kernel is not deterministic")
            c = shape[-1]
            x_ncdhw = x.permute(0, 4, 1, 2, 3).contiguous()
            g_ncdhw = g.permute(0, 4, 1, 2, 3).contiguous()
            w_conv = w.permute(3, 0, 1, 2).reshape(c, 1, 3, 3, 3).contiguous()
            bound_ms, bound_by = wgrad_bound(shape, dtype)
            rec = {
                "kernel": "depthwise3x3x3_wgrad",
                "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "launches_per_forward": per_forward,
                "dx_max_abs_err": float((xg.grad.float() - dx_ref).abs().max()),
                "max_abs_err": float((wg.grad.float() - dw_ref).abs().max()),
                "dw_max_abs": float(dw_ref.abs().max()),
                "kernel_ms": time_ms(lambda: depthwise3x3x3_wgrad(x, g), flush=flush),
                "kernel_warm_ms": time_ms(lambda: depthwise3x3x3_wgrad(x, g)),
                "plain_ms": time_ms(lambda: depthwise3x3x3_wgrad_plain(x, g), flush=flush),
                "library_ms": time_ms(
                    lambda: torch.ops.aten.convolution_backward(
                        g_ncdhw, x_ncdhw, w_conv, None, [1, 1, 1], [1, 1, 1],
                        [1, 1, 1], False, [0, 0, 0], c, [False, True, False],
                    ),
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


def _train_cfg(tiny=False):
    from pmv_tpu_torch.entry import apply_bench_recipe, mvitv2_s_cfg

    cfg = apply_bench_recipe(mvitv2_s_cfg(tiny))
    cfg.SOLVER.BASE_LR = TRAIN_LR
    return cfg


def phase_train_step_vs_cpu():
    """One full-width float32 train step at batch 2, card against CPU, from
    the same weights and the same draws."""
    from pmv_tpu_torch.engine.steps import init_state, make_train_step
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.ops.depthwise import depthwise3x3x3, depthwise3x3x3_wgrad

    cfg = _train_cfg()
    cpu_model = build_model(cfg, device="cpu", dtype=torch.float32, seed=0)
    gpu_model = build_model(cfg, device="cuda", dtype=torch.float32, seed=0)
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    before = {k: v.detach().clone() for k, v in cpu_model.state_dict().items()}
    cpu_state, gpu_state = init_state(cfg, cpu_model), init_state(cfg, gpu_model)
    cpu_step = make_train_step(cfg, device="cpu", seed=0)
    gpu_step = make_train_step(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(2)
    size = cfg.DATA.TRAIN_CROP_SIZE
    batch = {
        "frames": rng.integers(0, 256, (2, cfg.DATA.NUM_FRAMES, size, size, 3), np.uint8),
        "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, 2),
    }
    draws = cpu_step.sample_draws(cpu_model, batch["frames"].shape)

    k1, wg = depthwise3x3x3.launches, depthwise3x3x3_wgrad.launches
    t0 = time.perf_counter()
    gpu = {k: v.cpu() for k, v in gpu_step(gpu_state, batch, TRAIN_LR, draws).items()}
    gpu_s = time.perf_counter() - t0
    launches = {"depthwise3x3x3": depthwise3x3x3.launches - k1,
                "depthwise3x3x3_wgrad": depthwise3x3x3_wgrad.launches - wg}
    t0 = time.perf_counter()
    cpu = cpu_step(cpu_state, batch, TRAIN_LR, draws)
    cpu_s = time.perf_counter() - t0

    grad_diff = grad_ref = 0.0
    for (name, p_cpu), p_gpu in zip(cpu_model.named_parameters(), gpu_model.parameters()):
        grad_diff += float((p_gpu.grad.cpu() - p_cpu.grad).square().sum())
        grad_ref += float(p_cpu.grad.square().sum())
    grad_rel = (grad_diff / grad_ref) ** 0.5
    params_gpu = {k: v.cpu() for k, v in gpu_model.state_dict().items()}
    param_err = max(float((params_gpu[k] - v).abs().max())
                    for k, v in cpu_model.state_dict().items())
    n_params = sum(v.numel() for v in before.values())
    n_off = sum(int(((params_gpu[k] - v).abs() > 1e-6).sum())
                for k, v in cpu_model.state_dict().items())
    moved = sum(int((cpu_model.state_dict()[k] != v).sum()) for k, v in before.items())
    log(json.dumps({
        "phase": "train_step_f32_b2_card_vs_cpu", "depth": cfg.MVIT.DEPTH,
        "launches": launches, "loss": [float(gpu["loss"]), float(cpu["loss"])],
        "grad_norm": [float(gpu["grad_norm"]), float(cpu["grad_norm"])],
        "top1_err": [float(gpu["top1_err"]), float(cpu["top1_err"])],
        "top5_err": [float(gpu["top5_err"]), float(cpu["top5_err"])],
        "grad_rel_err": grad_rel, "param_max_abs_err": param_err,
        "params_off_by_1e-6": n_off, "params": n_params, "params_moved": moved,
        "gpu_first_call_s": gpu_s, "cpu_s": cpu_s,
    }))
    if launches != {"depthwise3x3x3": 34, "depthwise3x3x3_wgrad": 17}:
        raise AssertionError(f"one train step launched {launches}, not 34 K1 and 17 wgrad")
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(gpu[key], cpu[key], atol=0, rtol=1e-4)
    for key in ("top1_err", "top5_err", "nan"):
        if not torch.equal(gpu[key], cpu[key]):
            raise AssertionError(f"{key}: card {gpu[key]} against CPU {cpu[key]}")
    if grad_rel > 1e-4:
        raise AssertionError(f"gradients differ by {grad_rel} (relative L2)")
    # AdamW's first step moves each weight by about lr * sign(g); a gradient
    # element within float noise of 0 (the K-norm bias, which the loss does
    # not depend on) may take the other sign on the two sides: 2 lr at most.
    if param_err > 2.0001 * TRAIN_LR or n_off > 1e-4 * n_params:
        raise AssertionError(
            f"updated parameters differ: max {param_err}, {n_off} off by > 1e-6"
        )
    if moved < 0.5 * n_params:
        raise AssertionError(f"only {moved} of {n_params} weights moved")


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


def phase_train(card):
    """The slice's main path: train_epoch over synthetic batch-8 clips."""
    from pmv_tpu_torch.engine.steps import init_state, make_train_step
    from pmv_tpu_torch.engine.train import train_epoch
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.ops.depthwise import depthwise3x3x3, depthwise3x3x3_wgrad
    from pmv_tpu_torch.utils.meters import TrainMeter

    cfg = _train_cfg()
    timed, batch = 5, 8
    cfg.LOG_PERIOD = timed
    cfg.SOLVER.MAX_EPOCH = 1
    model = build_model(cfg, device="cuda", seed=0)  # bfloat16 activations
    state = init_state(cfg, model)
    step = make_train_step(cfg, device="cuda", seed=0)
    metrics = []

    def recording_step(state, batch, lr):
        m = step(state, batch, lr)
        metrics.append(m)
        return m

    rng = np.random.default_rng(3)
    size = cfg.DATA.TRAIN_CROP_SIZE
    loader = [
        {"frames": rng.integers(0, 256, (batch, cfg.DATA.NUM_FRAMES, size, size, 3), np.uint8),
         "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, batch)}
        for _ in range(1 + timed)
    ]
    t0 = time.perf_counter()
    train_epoch(loader[:1], recording_step, state, TrainMeter(1, cfg), 0, cfg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    depthwise3x3x3.launches = 0  # the main path starts here
    depthwise3x3x3_wgrad.launches = 0
    t0 = time.perf_counter()
    train_epoch(loader[1:], recording_step, state, TrainMeter(timed, cfg), 0, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"depthwise3x3x3": depthwise3x3x3.launches,  # ... and ends here
                "depthwise3x3x3_wgrad": depthwise3x3x3_wgrad.launches}
    peak = torch.cuda.max_memory_allocated()

    losses = [float(m["loss"]) for m in metrics]
    grad_norms = [float(m["grad_norm"]) for m in metrics]
    if not np.all(np.isfinite(losses + grad_norms)):
        raise AssertionError(f"non-finite losses {losses} or grad norms {grad_norms}")
    if launches != {"depthwise3x3x3": 34 * timed, "depthwise3x3x3_wgrad": 17 * timed}:
        raise AssertionError(f"{timed} train steps launched {launches}, "
                             "not 34 K1 and 17 wgrad per step")
    log(json.dumps({
        "phase": "train_bf16_b8", "card": card, "steps": timed, "batch": batch,
        "wall_s": wall, "ms_per_step": wall / timed * 1e3,
        "clips_per_s": timed * batch / wall, "warmup_step_s": warm_s,
        "max_memory_allocated_bytes": peak, "launches": launches,
        "losses": losses, "grad_norms": grad_norms, "steps_taken": state.step,
    }))
    return launches


def kernels_line(records, launches):
    """One entry per kernel: times summed over the launches at the main
    path's shapes in bfloat16 at batch 8; K1 over one forward (17 launches,
    as many again for dx in a train step), the wgrad kernel over one train
    step (17 launches)."""

    def entry(name, source, replaces, recs, basis):
        main = [r for r in recs if r["dtype"] == "bfloat16" and r["launches_per_forward"]]

        def summed(key):
            return sum(r[key] * r["launches_per_forward"] for r in main)

        kernel_ms = summed("kernel_ms")
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": kernel_ms,
            "kernel_ms": kernel_ms,
            "kernel_warm_ms": summed("kernel_warm_ms"),
            "plain_ms": summed("plain_ms"),
            "bound_ms": summed("bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main) else "operations",
            "library_ms": summed("library_ms"),
            "ms_basis": basis,
        }

    fwd = [r for r in records if r["kernel"] == "depthwise3x3x3"]
    bwd = [r for r in records if r["kernel"] == "depthwise3x3x3_wgrad"]
    return {"kernels": [
        entry("depthwise3x3x3", "pmv_tpu_torch/ops/csrc/depthwise3x3x3.cu",
              "pmv_tpu/ops/depthwise_pallas.py:77", fwd,
              "17 launches: one batch-8 bf16 forward"),
        entry("depthwise3x3x3_wgrad", "pmv_tpu_torch/ops/csrc/depthwise3x3x3_wgrad.cu",
              "pmv_tpu/ops/depthwise_pallas.py:134", bwd,
              "17 launches: one batch-8 bf16 train step"),
    ]}


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
    spills = [line.strip() for output in kernel_build.build_log.values()
              for line in output.splitlines()
              if any(int(n) for n in re.findall(r"(\d+) bytes spill", line))]
    if spills:
        raise AssertionError("ptxas reports spills:\n" + "\n".join(spills))

    # Phase 2: every kernel against its plain version.
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    records = phase_kernels(flush) + phase_backward(flush)
    del flush

    # Phase 3: the full model on the card and on the CPU, eval and train.
    frames = np.random.default_rng(1).integers(0, 256, (1, 16, 224, 224, 3), np.uint8)
    phase_full_model(frames)
    phase_train_step_vs_cpu()

    # Phases 4 and 5: the main paths, serving and training.
    served = phase_serve(card)
    trained = phase_train(card)
    launches = {
        "depthwise3x3x3": served["depthwise3x3x3"] + trained["depthwise3x3x3"],
        "depthwise3x3x3_wgrad": trained["depthwise3x3x3_wgrad"],
    }

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
