"""TensorBoard writer (`MViT/slowfast/visualization/tensorboard_vis.py:20-429`).

Counterpart of `pmv_tpu/visualization/tensorboard_vis.py`, which already
writes through ``torch.utils.tensorboard``; the same log directory, tags and
values. ``train()`` writes its evaluation's errors through it, on rank 0
only. The JAX writer's video, histogram and confusion-matrix plots have no
caller in the port yet (their one caller there, VIS_MASK, is not ported).
"""

import os

from pmv_tpu_torch.utils import logging as pmv_logging

logger = pmv_logging.get_logger(__name__)


class TensorboardWriter:
    def __init__(self, cfg):
        if cfg.TENSORBOARD.LOG_DIR == "":
            log_dir = os.path.join(
                cfg.OUTPUT_DIR, "runs-{}".format(cfg.TRAIN.DATASET)
            )
        else:
            log_dir = os.path.join(cfg.OUTPUT_DIR, cfg.TENSORBOARD.LOG_DIR)
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=log_dir)
        logger.info("TensorBoard events at %s", log_dir)

    def add_scalars(self, data_dict, global_step=None):
        for key, item in data_dict.items():
            self.writer.add_scalar(key, item, global_step)

    def close(self):
        self.writer.flush()
        self.writer.close()
