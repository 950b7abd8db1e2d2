"""Train, then test (`MViT/tools/run_net.py:15-49`, `tools/run_net.py`).

    python -m pmv_tpu_torch.tools.run_net --cfg <yaml> [--device cpu] \\
        [--num_shards N --shard_id I --init_method tcp://host:port] \\
        [--opts KEY VALUE ...]

The ``--cfg``/``--opts`` surface of ``config/parser.py``, the JAX package's
CLI's, so the `exps/PMV` recipes' options carry over. It runs on the CUDA
devices unless ``--device cpu`` is given, and raises without one.
NUM_GPUS x NUM_SHARDS above 1 makes a multi-process job
(``parallel.distributed.launch_job``): on each host ("shard", ``--shard_id``
of ``--num_shards``, all meeting at ``--init_method``) NUM_GPUS processes,
one per card, each taking TRAIN.BATCH_SIZE / NUM_GPUS clips a step; so a
recipe's yaml with NUM_GPUS 8 needs eight cards, or NUM_GPUS 1 for one.
TRAIN.ENABLE trains; TEST.ENABLE tests, sweeping NUM_ENSEMBLE_VIEWS over
[1, 3, 5, 7, 10] when it is -1, or over TEST.NUM_TEMPORAL_CLIPS when that is
set. The SSL models, MaskMViT (MaskFeat pre-training) and ContrastiveModel
(MoCo, SimCLR, BYOL, SwAV, memory bank, with the kNN monitor), train
through ``engine/ssl_train.py::train_ssl``, over several processes under
TPU.SHARD_STRATEGY "dp" or "fsdp". Under "dp_sp" (temporal sequence
parallelism, ``parallel/mesh.py``) the NUM_GPUS x NUM_SHARDS processes form
a (data, model) grid with a model axis of 2 (TPU.MESH_SHAPE's where it is
set), whose model groups each hold the same clips and cut them in T; it
takes every task: the classification models, MaskFeat and the contrastive
models, AVA detection, feature extraction and multigrid (``check``
refuses, before any process starts, a clip whose frames, or a multigrid
long cycle's, the model axis cannot cut).
After train and test, with TENSORBOARD.ENABLE and MODEL_VIS or
WRONG_PRED_VIS, ``tools/visualization.py::visualize`` writes the weight
histograms, Grad-CAM's predictions, the input and misclassified videos and
the confusion matrix; with DEMO.ENABLE the demo annotates DEMO.INPUT_VIDEO
(``visualization/demo.py``), or, with DETECTION.ENABLE and
DEMO.PREDS_BOXES, the AVA demo its precomputed boxes
(``visualization/ava_demo.py``), as the JAX package's CLI dispatches them
(`tools/run_net.py:66-88`); in a multi-process job rank 0 alone runs
them.
"""

import sys

from pmv_tpu_torch.config.defaults import assert_and_infer_cfg
from pmv_tpu_torch.config.parser import load_config, parse_args
from pmv_tpu_torch.engine import ssl_train
from pmv_tpu_torch.parallel import distributed
from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils.device import resolve_device


def run(cfg, device):
    """Train, test, visualize and run the demo for one config."""
    if cfg.TRAIN.ENABLE and cfg.MODEL.MODEL_NAME in ssl_train.SSL_MODELS:
        # `tools/run_net.py:38-43` of the JAX package
        ssl_train.train_ssl(cfg, device=device)
    elif cfg.TRAIN.ENABLE:
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
    if not pmv_logging.is_master_process():
        return  # one process visualizes and runs the demo
    if cfg.TENSORBOARD.ENABLE and (
        cfg.TENSORBOARD.MODEL_VIS.ENABLE or cfg.TENSORBOARD.WRONG_PRED_VIS.ENABLE
    ):
        from pmv_tpu_torch.tools.visualization import visualize

        visualize(cfg, device=device)
    if cfg.DEMO.ENABLE:
        if cfg.DETECTION.ENABLE and cfg.DEMO.PREDS_BOXES:  # `demo_net.py:96-105`
            from pmv_tpu_torch.visualization.ava_demo import ava_demo

            ava_demo(cfg, device=device)
        else:
            from pmv_tpu_torch.visualization.demo import demo

            demo(cfg, device=device)


def check(cfg):
    """Raise before any process starts where the job of ``cfg`` cannot run
    its layout: under dp_sp, frames that do not split over the model axis,
    at DATA.NUM_FRAMES and at each multigrid long cycle's
    (``distributed.check_sequence_parallel``)."""
    distributed.check_sequence_parallel(cfg)
    if cfg.MULTIGRID.LONG_CYCLE and cfg.TRAIN.ENABLE:
        from pmv_tpu_torch.utils.multigrid import MultigridSchedule

        schedule = MultigridSchedule()
        schedule.init_multigrid(cfg.clone())
        for _, (_, frames, crop), end in schedule.schedule:
            distributed.check_sequence_parallel(
                cfg, frames, f"the long cycle's frames (crop {crop}, until epoch {end})")


def main(argv=None):
    args = parse_args(argv)
    if args.cfg_files is None:  # the parser printed its help
        return 0
    device = resolve_device(args.device)
    for path in args.cfg_files:
        cfg = assert_and_infer_cfg(load_config(args, path))
        check(cfg)
        distributed.launch_job(cfg, args.init_method, run, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
