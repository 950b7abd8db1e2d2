"""Time the strided depthwise pool convs of MViTv2-S 16x4 through F.conv3d,
in the layout the port passes today and in the alternatives, on one card;
with ``--uniformer``, UniFormer-S 16x4's 5x5x5 depthwise convs instead; with
``--x3d``, X3D-M's convs that K1 does not run.

    python -m pmv_tpu_torch.tools.pool_conv_variants [--uniformer | --x3d]

The port sends every strided conv pool to a grouped ``F.conv3d`` on a
contiguous NCDHW copy of the channels-last grid
(``models/common.py::channels_last_conv3d``). For each strided-pool shape
of one batch-8 bfloat16 forward it prints one JSON line with the median
device ms (CUDA events) of:
- "view": the conv on the channels-last grid viewed as NCDHW;
- "ncdhw": the same conv on a contiguous NCDHW copy (the copy not timed);
- "ncdhw_with_copies": the copy in, the conv, and the copy back to NDHWC;
each with cudnn.benchmark off and on; then one line summed over a forward.

``--uniformer``: the CBlock's stride-1 SAME 5x5x5 depthwise conv (with its
bias) at its two grids; ``--x3d``: the stem's 1x3x3 conv (3 -> 24 channels,
stride (1, 2, 2)) and 5x1x1 depthwise conv, and the strided (1, 2, 2)
channelwise 3x3x3 conv that opens each stage (C = 54, 108, 216, 432) at
the 224^2 crop. Batch 8, bfloat16, each layout from channels-last
[B, T, H, W, C] to channels-last: "view" (the grid viewed as NCDHW),
"ncdhw_with_copies" (a contiguous NCDHW copy in, the output viewed back);
forward alone, and forward and backward (dx and dw); the two layouts'
outputs and gradients must agree.
"""

import argparse
import json
import sys
from collections import defaultdict

import torch
import torch.nn.functional as F

from pmv_tpu_torch.tools.timing import card_line, time_ms

BATCH = 8
# (grid [T, H, W, C], stride, pools per forward) of MViTv2-S 16x4.
STRIDED_POOLS = [
    ((8, 56, 56, 96), (1, 8, 8), 2),    # block 0 K, V
    ((8, 56, 56, 192), (1, 2, 2), 1),   # block 1 q
    ((8, 56, 56, 192), (1, 4, 4), 2),   # block 1 K, V
    ((8, 28, 28, 192), (1, 4, 4), 2),   # block 2 K, V
    ((8, 28, 28, 384), (1, 2, 2), 3),   # block 3 q, K, V
    ((8, 14, 14, 384), (1, 2, 2), 20),  # blocks 4-13 K, V
    ((8, 14, 14, 768), (1, 2, 2), 1),   # block 14 q
]


# (name, input grid [T, H, W, C], output channels, kernel, stride, padding,
# groups, bias, convs per forward): UniFormer-S 16x4's CBlock 5x5x5 convs.
UNIFORMER_CONVS = [
    ("stage 1", (8, 56, 56, 64), 64, (5, 5, 5), (1, 1, 1), (2, 2, 2), 64, True, 3),
    ("stage 2", (8, 28, 28, 128), 128, (5, 5, 5), (1, 1, 1), (2, 2, 2), 128, True, 4),
]
# X3D-M's convs that K1 does not run: the stem's (configs/Kinetics/X3D_M.yaml,
# 224^2 crop) and the first, strided, channelwise conv of each stage.
X3D_CONVS = [
    ("stem conv_xy", (16, 224, 224, 3), 24, (1, 3, 3), (1, 2, 2), (0, 1, 1), 1, False, 1),
    ("stem conv", (16, 112, 112, 24), 24, (5, 1, 1), (1, 1, 1), (2, 0, 0), 24, False, 1),
    ("s2 branch2.b", (16, 112, 112, 54), 54, (3, 3, 3), (1, 2, 2), (1, 1, 1), 54, False, 1),
    ("s3 branch2.b", (16, 56, 56, 108), 108, (3, 3, 3), (1, 2, 2), (1, 1, 1), 108, False, 1),
    ("s4 branch2.b", (16, 28, 28, 216), 216, (3, 3, 3), (1, 2, 2), (1, 1, 1), 216, False, 1),
    ("s5 branch2.b", (16, 14, 14, 432), 432, (3, 3, 3), (1, 2, 2), (1, 1, 1), 432, False, 1),
]


def layouts(card, convs, label):
    """Each conv of ``convs`` in both layouts, forward and forward +
    backward; one JSON line per conv, then the sums over a forward."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    total = defaultdict(float)
    for name, grid, c_out, kernel, stride, padding, groups, has_bias, count in convs:
        c = grid[-1]
        x = torch.randn((BATCH, *grid), generator=gen, device="cuda").bfloat16()
        w = (0.05 * torch.randn((c_out, c // groups, *kernel), generator=gen,
                                device="cuda")).bfloat16()
        b = torch.randn((c_out,), generator=gen, device="cuda").bfloat16() if has_bias else None

        def view(x, w):
            return F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, stride, padding,
                            groups=groups).permute(0, 2, 3, 4, 1)

        def ncdhw_with_copies(x, w):
            return F.conv3d(x.permute(0, 4, 1, 2, 3).contiguous(), w, b, stride, padding,
                            groups=groups).permute(0, 2, 3, 4, 1)

        g = torch.randn(view(x, w).shape, generator=gen, device="cuda").bfloat16()
        rec = {"conv": name, "grid": [BATCH, *grid], "stride": list(stride),
               "count": count, "dtype": "bfloat16"}
        results = []
        for fn in (view, ncdhw_with_copies):
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            times = {
                "fwd_ms": time_ms(lambda: fn(x, w), iters=10),
                "fwd_bwd_ms": time_ms(lambda: fn(xg, wg).backward(g), iters=10),
            }
            for key, ms in times.items():
                rec[f"{fn.__name__}_{key}"] = ms
                total[f"{fn.__name__}_{key}"] += ms * count
            xg.grad = wg.grad = None
            fn(xg, wg).backward(g)
            results.append((fn(x, w).float(), xg.grad.float(), wg.grad.float()))
        # bfloat16 outputs and gradients; dw sums B*T*H*W products, so its
        # rounding is relative to its largest entries.
        for ours, theirs in zip(*results):
            torch.testing.assert_close(ours, theirs, atol=1e-2 * float(theirs.abs().max()),
                                       rtol=1e-2)
        print(json.dumps(rec), flush=True)
    print(json.dumps({f"{label}_per_forward_ms": dict(total), "batch": BATCH, "card": card}),
          flush=True)
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--uniformer", action="store_true",
                        help="time UniFormer's 5x5x5 depthwise convs instead")
    parser.add_argument("--x3d", action="store_true",
                        help="time X3D-M's stem and strided channelwise convs instead")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("pool_conv_variants: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    if args.uniformer:
        return layouts(card, UNIFORMER_CONVS, "uniformer")
    if args.x3d:
        return layouts(card, X3D_CONVS, "x3d")
    gen = torch.Generator(device="cuda").manual_seed(0)
    total = defaultdict(float)
    for grid, stride, count in STRIDED_POOLS:
        c = grid[-1]
        x = torch.randn((BATCH, *grid), generator=gen, device="cuda").bfloat16()
        w = torch.randn((c, 1, 3, 3, 3), generator=gen, device="cuda").bfloat16()
        x_nc = x.permute(0, 4, 1, 2, 3).contiguous()

        def view():
            return F.conv3d(x.permute(0, 4, 1, 2, 3), w, stride=stride,
                            padding=1, groups=c)

        def ncdhw():
            return F.conv3d(x_nc, w, stride=stride, padding=1, groups=c)

        def ncdhw_with_copies():
            y = F.conv3d(x.permute(0, 4, 1, 2, 3).contiguous(), w,
                         stride=stride, padding=1, groups=c)
            return y.permute(0, 2, 3, 4, 1).contiguous()

        rec = {"grid": [BATCH, *grid], "stride": list(stride), "count": count}
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            for fn in (view, ncdhw, ncdhw_with_copies):
                key = f"{fn.__name__}{'_cudnn_benchmark' if bench else ''}_ms"
                rec[key] = time_ms(fn, iters=10)
                total[key] += rec[key] * count
        torch.backends.cudnn.benchmark = False
        torch.testing.assert_close(view().float(), ncdhw().float())
        print(json.dumps(rec), flush=True)
    print(json.dumps({"per_forward_ms": dict(total), "batch": BATCH, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
