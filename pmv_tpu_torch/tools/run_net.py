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
takes the MViT classification model and UniFormer. SSL under "dp_sp",
another model under "dp_sp", the model and wrong-prediction visualization
and the demo are not ported and raise NotImplementedError.
"""

import sys

from pmv_tpu_torch.config.defaults import assert_and_infer_cfg
from pmv_tpu_torch.config.parser import load_config, parse_args
from pmv_tpu_torch.engine import ssl_train
from pmv_tpu_torch.parallel import distributed
from pmv_tpu_torch.utils.device import resolve_device


def run(cfg, device):
    """Train and test one config."""
    if cfg.TENSORBOARD.ENABLE and (
        cfg.TENSORBOARD.MODEL_VIS.ENABLE or cfg.TENSORBOARD.WRONG_PRED_VIS.ENABLE
    ):
        raise NotImplementedError("TensorBoard's model and wrong-prediction visualization "
                                  "are not ported")
    if cfg.DEMO.ENABLE:
        raise NotImplementedError("the demo is not ported")
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


def main(argv=None):
    args = parse_args(argv)
    if args.cfg_files is None:  # the parser printed its help
        return 0
    device = resolve_device(args.device)
    for path in args.cfg_files:
        cfg = assert_and_infer_cfg(load_config(args, path))
        if cfg.MODEL.MODEL_NAME in ssl_train.SSL_MODELS:  # before any process starts
            ssl_train.refuse_unported_ssl(cfg)
        else:
            distributed.refuse_sequence_parallel(cfg)
        distributed.launch_job(cfg, args.init_method, run, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
