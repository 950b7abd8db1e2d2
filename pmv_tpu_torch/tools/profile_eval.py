"""Time and profile the port's eval or train step on one CUDA card:
MViTv2-S 16x4's, or that of any config given with ``--cfg`` (UniFormer-S
16x4's: ``--cfg configs/Kinetics/UNIFORMER_S_16x4.yaml --opts
UNIFORMER.PRETRAIN_NAME "" TENSORBOARD.ENABLE False``; X3D-M's: ``--cfg
configs/Kinetics/X3D_M.yaml``, its eval at the 256^2 test crop; SlowFast
8x8 R50's: ``--cfg configs/Kinetics/SLOWFAST_8x8_R50.yaml``, 32 frames a
clip, of which the slow pathway takes 8; ir-CSN-101's: ``--cfg
configs/Kinetics/CSN_32x2_R101.yaml``, whose 30 stride-1 conv_bs run K1;
R(2+1)D-50's: ``--cfg configs/Kinetics/R2PLUS1D_16x4_R50.yaml``); MaskFeat
pre-training's train step
with ``--train --cfg configs/masked_ssl/k400_MVITv2_S_16x4_MaskFeat_PT.yaml``
(the masked step of ``engine/ssl_steps.py``, the model drawing its masks);
a contrastive yaml's with ``--train --cfg
configs/contrastive_ssl/MoCo_SlowR50_8x8.yaml`` (the contrastive step of
``engine/ssl_steps.py``; ``--batch`` videos of two views each); an AVA
yaml's (``--cfg configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml``, DETECTION.ENABLE)
with 16 box slots a clip, 3 valid (``grad_witness.detection_boxes``),
through the detection steps.

    python -m pmv_tpu_torch.tools.profile_eval [--train] [--batch 8] [--steps 10] [--top 20] \\
        [--cfg <yaml> [--opts KEY VALUE ...]]

The step runs as it serves, or with ``--train`` as it trains (the bench
recipe of ``entry.apply_bench_recipe``: RandAugment, erasing, MixUp/CutMix,
DropPath, AdamW at LR 1e-4): bfloat16 activations (``compute_dtype``).
With ``--cfg`` the model and the step come from that config and its
``--opts``, as ``run_net`` builds them, at its crop (the RECT one where
set); ``--batch`` counts clips, so a train step of TRAIN.BATCH_SIZE videos
of AUG.NUM_SAMPLE clips each is ``--batch`` their product.
Prints JSON lines:
- "step": steady-state ms per step and clips/s (host clock around steps
  that end in a synchronize), and peak device memory, beside the card's
  name and power limit;
- "detection" (an AVA yaml): the RoI head alone (its forward, and with
  ``--train`` its backward) and RoIAlign alone on the inputs the step gave
  the head, in ms by CUDA events, beside the step's ms;
- "profile": from a torch.profiler window over 3 steps, the device's
  busy share (the time at least one kernel ran, over the window's wall
  time), the summed kernel ms per step (larger than the busy time where
  kernels overlap: cuDNN's grouped weight gradient runs its kernels side by
  side) and by kind of kernel, the busy ms by kind (the time at least one
  kernel of the kind ran), and the top kernels by device time. User
  annotations (``Optimizer.step``) are left out.
The frames are random uint8 clips made on the card, so no host copy is
timed; weights are random from a seed.
"""

import argparse
import json
import re
import sys
import time
from collections import defaultdict

import torch

PROFILE_STEPS = 3

# Kinds of kernel, matched on the kernel's name in this order.
KINDS = [
    ("depthwise wgrad", r"dw3x3x3_wgrad"),
    ("depthwise3x3x3 (K1)", r"dw3x3x3"),
    # cuDNN's convs (and its layout transposes) before matmul: their
    # names contain "gemm" too. ATen's own depthwise 3-D conv kernels
    # (conv_depthwise3d_cuda_*, UniFormer's 5x5x5 conv) fall here as well.
    ("conv (cuDNN, ATen)", r"conv|cudnn|fprop|winograd|fft"),
    ("matmul", r"gemm|xmma|cutlass|cublas|nvjet"),
    ("softmax", r"softmax"),
    ("layer_norm", r"layer_norm|LayerNorm"),
    ("reduce", r"reduce"),
    ("copy / cat / pad", r"copy|cat|Cat|pad|index|gather|scatter"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
]


def kind_of(name):
    for kind, pattern in KINDS:
        if re.search(pattern, name):
            return kind
    return "other"


def union_us(intervals):
    """Length of the union of (start, end) intervals: the time at least one
    kernel ran, which is less than their sum where kernels overlap."""
    total, end_max = 0.0, None
    for start, end in sorted(intervals):
        if end_max is None or start > end_max:
            total += end - start
            end_max = end
        elif end > end_max:
            total += end - end_max
            end_max = end
    return total


def _event_ms(fn, iters):
    """The mean ms of ``fn`` over ``iters`` calls, by CUDA events, after one
    call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roi_head_ms(model, step, train, iters):
    """The detection head's ms and RoIAlign's alone, on the inputs one
    ``step`` gives the head (its pathways' grids, the boxes, the mask, the
    dropout mask), with their backward in training."""
    from pmv_tpu_torch.ops.roi_align import roi_align

    head = model.head
    seen = []
    hook = head.register_forward_pre_hook(lambda _, args: seen.append(args))
    step()
    hook.remove()
    xs, boxes, box_mask, *rest = seen[-1]
    xs = [x.detach() for x in xs]
    b, m = boxes.shape[:2]
    idx = torch.arange(b, device=boxes.device).repeat_interleave(m)

    def run(fn):
        if not train:
            with torch.inference_mode():
                return fn(xs)
        out = fn([x.clone().requires_grad_() for x in xs])
        torch.cat([o.float().flatten() for o in out]).sum().backward()

    def head_call(ins):
        return [head(ins, boxes, box_mask, *rest)]

    def roi_call(ins):
        return [roi_align(x.mean(dim=1), boxes.reshape(b * m, 4), idx,
                          (head.resolution, head.resolution), head.spatial_scale,
                          aligned=head.aligned) for x in ins]

    return {"boxes": b * m, "grids": [list(x.shape) for x in xs],
            "roi_head_ms": _event_ms(lambda: run(head_call), iters),
            "roi_align_ms": _event_ms(lambda: run(roi_call), iters)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--train", action="store_true",
                        help="profile the train step instead of the eval step")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--cfg", help="config file to build the model and step from")
    parser.add_argument("--opts", default=None, nargs=argparse.REMAINDER,
                        help="KEY VALUE pairs over --cfg")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_eval: no CUDA device", file=sys.stderr)
        return 1

    from pmv_tpu_torch.config.defaults import assert_and_infer_cfg
    from pmv_tpu_torch.config.parser import load_config
    from pmv_tpu_torch.engine import ssl_steps
    from pmv_tpu_torch.engine.steps import (
        init_state, make_detection_eval_step, make_eval_step, make_train_step)
    from pmv_tpu_torch.entry import apply_bench_recipe, mvitv2_s_cfg
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.tools.timing import card_line

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    if args.cfg:
        cfg = assert_and_infer_cfg(load_config(args, args.cfg))
    else:
        cfg = apply_bench_recipe(mvitv2_s_cfg()) if args.train else mvitv2_s_cfg()
    if cfg.MODEL.MODEL_NAME == "MaskMViT" and not args.train:
        print("profile_eval: MaskMViT has no eval step; pass --train", file=sys.stderr)
        return 1
    model = build_model(cfg, device="cuda", seed=0)
    if args.train:
        rect, size = cfg.DATA.TRAIN_CROP_SIZE_RECT, cfg.DATA.TRAIN_CROP_SIZE
    else:
        rect, size = cfg.DATA.TEST_CROP_SIZE_RECT, cfg.DATA.TEST_CROP_SIZE
    height, width = rect if len(rect) else (size, size)
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randint(
        0, 256, (args.batch, cfg.DATA.NUM_FRAMES, height, width, 3),
        dtype=torch.uint8, device="cuda", generator=gen,
    )
    if args.train and cfg.MODEL.MODEL_NAME == "MaskMViT":
        state = ssl_steps.init_masked_state(cfg, model)
        train_step = ssl_steps.make_masked_train_step(cfg, device="cuda")
        batch = {"frames": frames}

        def step():
            train_step(state, batch, 1e-4)
    elif args.train and cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        state = ssl_steps.init_ssl_state(cfg, model)
        train_step = ssl_steps.make_ssl_train_step(cfg, device="cuda")
        frames = torch.stack([frames, torch.randint(0, 256, frames.shape, dtype=torch.uint8,
                                                    device="cuda", generator=gen)], 1)
        batch = {"frames": frames, "index": torch.arange(args.batch, device="cuda")}

        def step():
            train_step(state, batch, 1e-4)
    elif cfg.DETECTION.ENABLE:
        import numpy as np

        from pmv_tpu_torch.tools.grad_witness import detection_boxes

        det = {k: torch.as_tensor(v, device="cuda") for k, v in detection_boxes(
            args.batch, width, cfg.MODEL.NUM_CLASSES, np.random.default_rng(0)).items()}
        if args.train:
            state = init_state(cfg, model)
            train_step = make_train_step(cfg, device="cuda")
            batch = {"frames": frames, **det}

            def step():
                train_step(state, batch, 1e-4)
        else:
            eval_step = make_detection_eval_step(cfg, model, device="cuda")

            def step():
                eval_step(frames, det["boxes"], det["box_mask"])
    elif args.train:
        state = init_state(cfg, model)
        train_step = make_train_step(cfg, device="cuda")
        batch = {"frames": frames, "labels": torch.randint(
            0, cfg.MODEL.NUM_CLASSES, (args.batch,), device="cuda", generator=gen)}

        def step():
            train_step(state, batch, 1e-4)
    else:
        eval_step = make_eval_step(cfg, model, device="cuda")

        def step():
            eval_step(frames)

    for _ in range(3):  # warm-up: cuDNN / cuBLAS plans, kernel build
        step()
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    print(json.dumps({
        "step": {"card": card, "train": args.train, "batch": args.batch,
                 "cfg": args.cfg, "frames": list(frames.shape),
                 "steps": args.steps, "ms_per_step": step_ms,
                 "clips_per_s": args.batch / step_ms * 1e3,
                 "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()},
    }), flush=True)

    if cfg.DETECTION.ENABLE:
        print(json.dumps({"detection": {"card": card, "train": args.train, **roi_head_ms(
            model, step, args.train, args.steps), "step_ms": step_ms}}), flush=True)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6

    by_kernel = defaultdict(lambda: [0.0, 0])
    intervals = defaultdict(list)  # kind -> (start, end) of its kernels
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            entry = by_kernel[evt.name]
            entry[0] += evt.time_range.elapsed_us()
            entry[1] += 1
            intervals[kind_of(evt.name)].append(
                (evt.time_range.start, evt.time_range.end))
    device_us = sum(t for t, _ in by_kernel.values())
    busy_us = union_us([iv for ivs in intervals.values() for iv in ivs])
    by_kind = defaultdict(float)
    for name, (t, _) in by_kernel.items():
        by_kind[kind_of(name)] += t
    busy_by_kind = {k: union_us(ivs) for k, ivs in intervals.items()}
    n = PROFILE_STEPS
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:args.top]
    print(json.dumps({
        "profile": {
            "card": card, "train": args.train, "batch": args.batch,
            "steps": n, "window_ms_per_step": window_us / n / 1e3,
            "device_ms_per_step": device_us / n / 1e3,
            "device_busy_ms_per_step": busy_us / n / 1e3,
            "device_busy_share": busy_us / window_us,
            "ms_per_step_by_kind": {
                k: v / n / 1e3 for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])
            },
            "busy_ms_per_step_by_kind": {
                k: v / n / 1e3
                for k, v in sorted(busy_by_kind.items(), key=lambda kv: -kv[1])
            },
            "top_kernels": [
                {"name": name[:120], "ms_per_step": t / n / 1e3,
                 "launches_per_step": c / n}
                for name, (t, c) in top
            ],
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
