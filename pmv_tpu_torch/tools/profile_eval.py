"""Time and profile the port's MViTv2-S 16x4 eval step on one CUDA card.

    python -m pmv_tpu_torch.tools.profile_eval [--batch 8] [--steps 10] [--top 20]

The step runs as it serves: bfloat16 activations (``compute_dtype``).
Prints JSON lines:
- "step": steady-state ms per step and clips/s (host clock around steps
  that end in a synchronize), and peak device memory, beside the card's
  name and power limit;
- "profile": from a torch.profiler window over 3 steps, the device's
  busy share (kernel time over the window's wall time), device ms per step
  by kind of kernel, and the top kernels by device time.
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
    ("depthwise3x3x3 (K1)", r"dw3x3x3"),
    # cuDNN's convs (and its layout transposes) before matmul: their
    # names contain "gemm" too.
    ("conv (cuDNN)", r"conv|cudnn|fprop|winograd|fft"),
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--top", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_eval: no CUDA device", file=sys.stderr)
        return 1

    from pmv_tpu_torch.engine.steps import make_eval_step
    from pmv_tpu_torch.entry import mvitv2_s_cfg
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.tools.timing import card_line

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    cfg = mvitv2_s_cfg()
    model = build_model(cfg, device="cuda", seed=0)
    eval_step = make_eval_step(cfg, model, device="cuda")
    size = cfg.DATA.TEST_CROP_SIZE
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randint(
        0, 256, (args.batch, cfg.DATA.NUM_FRAMES, size, size, 3),
        dtype=torch.uint8, device="cuda", generator=gen,
    )
    for _ in range(3):  # warm-up: cuDNN / cuBLAS plans, kernel build
        eval_step(frames)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eval_step(frames)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    print(json.dumps({
        "step": {"card": card, "batch": args.batch,
                 "steps": args.steps, "ms_per_step": step_ms,
                 "clips_per_s": args.batch / step_ms * 1e3,
                 "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()},
    }), flush=True)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            eval_step(frames)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6

    by_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            entry = by_kernel[evt.name]
            entry[0] += evt.time_range.elapsed_us()
            entry[1] += 1
    device_us = sum(t for t, _ in by_kernel.values())
    by_kind = defaultdict(float)
    for name, (t, _) in by_kernel.items():
        by_kind[kind_of(name)] += t
    n = PROFILE_STEPS
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:args.top]
    print(json.dumps({
        "profile": {
            "card": card, "batch": args.batch,
            "steps": n, "window_ms_per_step": window_us / n / 1e3,
            "device_ms_per_step": device_us / n / 1e3,
            "device_busy_share": device_us / window_us,
            "ms_per_step_by_kind": {
                k: v / n / 1e3 for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])
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
