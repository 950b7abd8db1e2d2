"""Time the strided depthwise pool convs of MViTv2-S 16x4 through F.conv3d,
in the layout the port passes today and in the alternatives, on one card.

    python -m pmv_tpu_torch.tools.pool_conv_variants

The port sends every strided conv pool to a grouped ``F.conv3d`` on a
channels-last grid viewed as NCDHW (``models/attention.py``). For each
strided-pool shape of one batch-8 bfloat16 forward it prints one JSON line
with the median device ms (CUDA events) of:
- "view": that call, as the port makes it;
- "ncdhw": the same conv on a contiguous NCDHW copy (the copy not timed);
- "ncdhw_with_copies": the copy in, the conv, and the copy back to NDHWC;
each with cudnn.benchmark off and on; then one line summed over a forward.
"""

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


def main():
    if not torch.cuda.is_available():
        print("pool_conv_variants: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
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
