"""Check the depthwise kernels' launch-plan rule against other plans on one
CUDA device.

    python -m pmv_tpu_torch.tools.plan_sweep [--iters N]

For each MViTv2-S 16x4 pool shape at batch 8 (``ops.depthwise
.MVIT_POOL_SHAPES``, which hold MaskFeat pre-training's too:
``MASKFEAT_POOL_SHAPES``; and a rank's under dp_sp, on 4 + 2 halo planes:
``MVIT_SP_POOL_SHAPES`` and ``MVIT_SP_SQUARE_POOL_SHAPES``), UniFormer-S's DPE
convs under dp_sp (``UNIFORMER_SP_DPE_SHAPES``,
``UNIFORMER_SP_TEST_DPE_SHAPES``), X3D-M's channelwise convs under dp_sp on
8 + 2 planes (``X3D_SP_DW_SHAPES``, ``X3D_SP_TEST_DW_SHAPES``; C = 54 and 108
padded to 56 and 112, as the wrappers pad them), ir-CSN-101's conv_bs under
dp_sp (``CSN_SP_DW_SHAPES``) and each
ir-CSN-101 conv_b shape at batch 8 on the train and the 256^2 test crop
(``CSN_DW_SHAPES``, ``CSN_TEST_DW_SHAPES``), dtype (bfloat16, float32) and kernel (K1, wgrad),
every plan of ``ops.depthwise.make_plan`` over tile rows 2, 4, 7 and 8,
the kernel's chunks, 1, 2 or 4 ranges of T and (wgrad) 1, 2 or 4 W segments runs
once against the plain version (it must agree, as in chip_smoke.py), then
is timed warm (median of ``--iters`` launches by CUDA events). Prints, per
case, the rule's plan (``plan_forward`` / ``plan_wgrad``) and the three
fastest, then the card's name and power limit.
"""

import argparse
import itertools
import json
import sys

import torch

from pmv_tpu_torch.ops import depthwise as dw
from pmv_tpu_torch.tools.timing import card_line, time_ms


def candidates(shape, elem_size, wgrad):
    plans = set()
    nvec = shape[-1] // (16 // elem_size)
    ths = sorted({min(t, shape[2]) for t in (2, 4, 7, 8)})
    chunks = range((dw.WGRAD_MAX_CHUNK_LOG2 if wgrad else dw.FWD_MAX_CHUNK_LOG2) + 1)
    for th, nv_log2, tsplit, nseg in itertools.product(
            ths, chunks, (1, 2, 4), (1, 2, 4) if wgrad else (None,)):
        if nvec % (1 << nv_log2) == 0:
            plan = dw.make_plan(shape, elem_size, wgrad, th, nv_log2, tsplit, nseg)
            if plan is not None and plan.threads >= 32:
                plans.add(plan)
    return list(plans)


def describe(plan):
    return {"th": plan.th, "nv": 1 << plan.nv_log2, "nseg": plan.nseg, "tt": plan.tt,
            "threads": plan.threads, "smem": plan.smem_bytes, "blocks": plan.blocks}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, _ in (dw.MVIT_POOL_SHAPES + dw.MVIT_SP_POOL_SHAPES
                     + dw.MVIT_SP_SQUARE_POOL_SHAPES + dw.UNIFORMER_SP_DPE_SHAPES
                     + dw.UNIFORMER_SP_TEST_DPE_SHAPES + dw.X3D_SP_DW_SHAPES
                     + dw.X3D_SP_TEST_DW_SHAPES + dw.CSN_SP_DW_SHAPES
                     + dw.CSN_DW_SHAPES + dw.CSN_TEST_DW_SHAPES):
        # The kernels' C: X3D's 54 and 108 as the wrappers pad them.
        shape = (*shape[:-1], shape[-1] + -shape[-1] % dw.CHANNEL_MULTIPLE)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (0.1 * torch.randn((3, 3, 3, shape[-1]), generator=gen, device="cuda")).to(dtype)
            bf16 = dtype == torch.bfloat16
            for wgrad in (False, True):
                if wgrad:
                    ref = dw.depthwise3x3x3_wgrad_plain(x.float(), g.float())
                    run = lambda p: dw._run_wgrad(x, g, p)  # noqa: E731
                    tol = (1e-2, 8e-3) if bf16 else (2e-3, 1e-5)
                    rule = dw.plan_wgrad(shape, x.element_size())
                else:
                    ref = dw.depthwise3x3x3_plain(x.float(), w.float())
                    run = lambda p: dw._run_forward(x, w, p)  # noqa: E731
                    tol = (1e-2, 8e-3) if bf16 else (1e-5, 1e-5)
                    rule = dw.plan_forward(shape, x.element_size())
                timed = []
                for plan in set(candidates(shape, x.element_size(), wgrad)) | {rule}:
                    torch.testing.assert_close(run(plan).float(), ref, atol=tol[0], rtol=tol[1])
                    timed.append((time_ms(lambda: run(plan), iters=args.iters), plan))
                timed.sort(key=lambda r: r[0])
                print(json.dumps({
                    "kernel": "wgrad" if wgrad else "fwd", "shape": list(shape),
                    "dtype": str(dtype)[6:], "plans": len(timed),
                    "rule": {"ms": next(ms for ms, p in timed if p == rule), **describe(rule)},
                    "best": [{"ms": ms, **describe(p)} for ms, p in timed[:3]],
                }), flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
