"""TensorBoard writer (`MViT/slowfast/visualization/tensorboard_vis.py:20-429`).

Counterpart of `pmv_tpu/visualization/tensorboard_vis.py`, which already
writes through ``torch.utils.tensorboard``; the same log directory, tags and
values. ``train()`` writes its evaluation's errors through it, on rank 0
only; VIS_MASK its comparison videos (``add_video``). The JAX writer's
histogram and confusion-matrix plots, whose caller is the model and
wrong-prediction visualization (`tools/visualization.py`), are not ported.
"""

import os

import numpy as np
import torch

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

    def add_video(self, video, tag, global_step=None, fps=4):
        """``video``: [B, T, H, W, C] uint8 (``torch.utils.tensorboard``
        encodes it with moviepy, and skips it where moviepy is absent)."""
        frames = torch.from_numpy(np.ascontiguousarray(video)).permute(0, 1, 4, 2, 3)
        self.writer.add_video(tag, frames, global_step=global_step, fps=fps)

    def close(self):
        self.writer.flush()
        self.writer.close()
