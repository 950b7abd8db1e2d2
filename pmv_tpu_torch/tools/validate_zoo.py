"""Released-checkpoint accuracy validation (`tools/validate_zoo.py` of the JAX
package): one command from a PyTorch ``.pyth``/``.pth``/``.pt`` file and a
val CSV to a multi-view top-1 against the reference model zoo.

    python -m pmv_tpu_torch.tools.validate_zoo \\
        --cfg configs/Kinetics/MVITv2_S_16x4.yaml \\
        --ckpt /path/K400_MVITv2_S_16x4.pyth [--device cpu] \\
        --opts NUM_GPUS 1 DATA.PATH_TO_DATA_DIR /path/k400_lists DATA.PATH_PREFIX ...

It prints a one-line JSON verdict. The checkpoint goes through the port's
loader (``utils/checkpoint.py``: a PySlowFast ``.pyth``, whose names are
the port's, as it is; a file without "model_state", or one that needs
2D->3D inflation, through ``utils/torch_import.py``) into the
multi-view test (``engine/test.py::test``, the protocol of the config's
TEST section), in this one process: NUM_GPUS x NUM_SHARDS must be 1 (the
released yamls say NUM_GPUS 8).

The expected top-1 comes from ``ZOO`` (MViT/MODEL_ZOO.md and
Uniformer/README.md, keyed by the config's file name) or from
--expected-top1. Exit code 0 iff |measured - expected| <= --tolerance
(default 0.3), or when nothing is expected. A dense-crop sweep
(TEST.DENSE_SPATIAL_CROP) is judged by its best crop; detection and
multi-label configs report mAP, and the tool refuses them. It runs on the
CUDA device unless ``--device cpu`` is given, as ``run_net`` does.
"""

import argparse
import json
import os
import sys

# Reference-published accuracies (config file name -> (top-1, protocol)).
ZOO = {
    "MVITv2_S_16x4.yaml": (81.0, "5 clips x 1 crop @224, K400"),
    "MVITv2_B_32x3.yaml": (82.9, "5 clips x 1 crop @224, K400"),
    "MVIT_B_16x4_CONV.yaml": (78.4, "5 clips x 1 crop @224, K400"),
    "MVIT_B_32x3_CONV.yaml": (80.4, "5 clips x 1 crop @224, K400"),
    "UNIFORMER_S_16x4.yaml": (80.8, "4 clips x 1 crop @224, K400"),
    "UNIFORMER_S_8x8_K400_exp.yaml": (78.4, "4 clips x 1 crop, K400"),
    "UNIFORMER_B_16x4_K400_exp.yaml": (82.0, "4 clips x 1 crop, K400"),
    "X3D_M.yaml": (75.1, "10 views @256, K400"),
    "X3D_XS.yaml": (68.7, "10 views, K400"),
    "X3D_S.yaml": (73.1, "10 views, K400"),
    "X3D_L.yaml": (76.9, "10 views, K400"),
    "SLOWFAST_8x8_R50.yaml": (77.0, "10 clips x 3 crops, K400"),
    "SLOWFAST_4x16_R50.yaml": (75.6, "10 clips x 3 crops, K400"),
    "I3D_8x8_R50.yaml": (73.5, "10 clips x 3 crops, K400"),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--ckpt", required=True, help=".pyth/.pth/.pt checkpoint")
    p.add_argument("--expected-top1", type=float, default=None,
                   help="override the built-in zoo expectation")
    p.add_argument("--tolerance", type=float, default=0.3)
    p.add_argument("--device", default="cuda",
                   help="the torch device to run on: cuda (the default) or cpu")
    # The JAX tool's overrides are a bare REMAINDER, which argparse refuses
    # to start at "--opts" (its docstring's usage); here both forms work.
    p.add_argument("--opts", dest="flag_opts", default=[], nargs=argparse.REMAINDER,
                   help="config overrides: KEY VALUE pairs")
    p.add_argument("opts", default=[], nargs=argparse.REMAINDER,
                   help="config overrides: KEY VALUE pairs, without --opts")
    args = p.parse_args(argv)
    args.opts = list(args.opts) + list(args.flag_opts)
    return args


def run(args):
    """Test ``args.ckpt`` under ``args.cfg_file``, print the verdict line;
    0 when it passes (or nothing is expected), else 1."""
    from pmv_tpu_torch.config import get_cfg
    from pmv_tpu_torch.config.defaults import assert_and_infer_cfg
    from pmv_tpu_torch.engine.test import test

    cfg = get_cfg()
    cfg.merge_from_file(args.cfg_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.TRAIN.ENABLE = False
    cfg.TEST.ENABLE = True
    cfg.TEST.CHECKPOINT_FILE_PATH = args.ckpt
    if args.ckpt.endswith((".pyth", ".pth", ".pt")):
        cfg.TEST.CHECKPOINT_TYPE = "pytorch"
    cfg = assert_and_infer_cfg(cfg)

    stats = test(cfg, device=args.device)
    if isinstance(stats, list):  # the dense-crop sweep's stats, one a crop
        stats = max(stats, key=lambda s: float(s.get("top1_acc", float("-inf"))))
    if "top1_acc" not in stats:
        raise SystemExit(
            "validate_zoo expects classification stats with 'top1_acc'; "
            f"got keys {sorted(stats)} — multi-label/detection configs "
            "report mAP and are not supported by this harness."
        )
    top1 = float(stats["top1_acc"])

    name = os.path.basename(args.cfg_file)
    expected, protocol = ZOO.get(name, (None, None))
    if args.expected_top1 is not None:
        expected = args.expected_top1
    verdict = {
        "config": name,
        "ckpt": args.ckpt,
        "top1": top1,
        "top5": float(stats.get("top5_acc", "nan")),
        "expected_top1": expected,
        "protocol": protocol,
    }
    if expected is not None:
        verdict["diff"] = round(top1 - expected, 3)
        verdict["pass"] = abs(top1 - expected) <= args.tolerance
    print(json.dumps(verdict), flush=True)
    return 0 if verdict.get("pass", True) else 1


def main(argv=None):
    sys.exit(run(parse_args(argv)))


if __name__ == "__main__":
    main()
