"""Train, then test (`MViT/tools/run_net.py:15-49`, `tools/run_net.py`).

    python -m pmv_tpu_torch.tools.run_net --cfg <yaml> [--device cpu] \\
        [--opts KEY VALUE ...]

The ``--cfg``/``--opts`` surface of ``config/parser.py``, the JAX package's
CLI's, so the `exps/PMV` recipes' options carry over. It runs on the CUDA
device unless ``--device cpu`` is given, and raises without one.
TRAIN.ENABLE trains; TEST.ENABLE tests, sweeping NUM_ENSEMBLE_VIEWS over
[1, 3, 5, 7, 10] when it is -1, or over TEST.NUM_TEMPORAL_CLIPS when that is
set. The self-supervised models, the visualization and the demo are not
ported and raise NotImplementedError. Multi-process runs (``--num_shards``)
wait for the torch.distributed port.
"""

import sys

from pmv_tpu_torch.config.defaults import assert_and_infer_cfg
from pmv_tpu_torch.config.parser import load_config, parse_args
from pmv_tpu_torch.utils.device import resolve_device


def run(cfg, device):
    """Train and test one config."""
    if cfg.MODEL.MODEL_NAME in ("ContrastiveModel", "MaskMViT"):
        raise NotImplementedError(f"{cfg.MODEL.MODEL_NAME} (self-supervised) is not ported")
    if cfg.TENSORBOARD.ENABLE or cfg.DEMO.ENABLE:
        raise NotImplementedError("the visualization and the demo are not ported")
    if cfg.TRAIN.ENABLE:
        from pmv_tpu_torch.engine.train import train

        train(cfg, device=device)
    if cfg.TEST.ENABLE:
        from pmv_tpu_torch.engine.test import test

        if cfg.TEST.NUM_ENSEMBLE_VIEWS == -1:
            views = [1, 3, 5, 7, 10]  # `run_net.py:30-41`
        elif len(cfg.TEST.NUM_TEMPORAL_CLIPS) > 0:
            views = list(cfg.TEST.NUM_TEMPORAL_CLIPS)  # `test_net.py:400-401`
        else:
            views = [cfg.TEST.NUM_ENSEMBLE_VIEWS]
        for num_view in views:
            sweep = cfg.clone()
            sweep.TEST.NUM_TEMPORAL_CLIPS = []
            sweep.TEST.NUM_ENSEMBLE_VIEWS = num_view
            test(sweep, device=device)


def main(argv=None):
    args = parse_args(argv)
    if args.cfg_files is None:  # the parser printed its help
        return 0
    if args.num_shards != 1:
        raise NotImplementedError("multi-process runs (torch.distributed) are not ported")
    device = resolve_device(args.device)
    for path in args.cfg_files:
        cfg = assert_and_infer_cfg(load_config(args, path))
        run(cfg, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
