"""Synthetic video dataset (`pmv_tpu/data/synthetic.py`).

Deterministic random clips at the configured geometry (``NUM_VIDEOS``
videos, the JAX package's 64; a clip is a function of its video's index),
so the full train/eval/test stack runs without video IO; the same clips and
labels as the JAX package's. Registered as DATASET 'synthetic'.
"""

import numpy as np

from pmv_tpu_torch.data.build import DATASET_REGISTRY


@DATASET_REGISTRY.register(name="Synthetic")
class Synthetic:
    NUM_VIDEOS = 64

    def __init__(self, cfg, mode):
        assert mode in ["train", "val", "test"]
        self.cfg = cfg
        self.mode = mode
        self._num_clips = (
            1
            if mode in ["train", "val"]
            else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        )
        self._num_videos = self.NUM_VIDEOS
        is_test = mode == "test"
        rect = (
            cfg.DATA.TEST_CROP_SIZE_RECT if is_test
            else cfg.DATA.TRAIN_CROP_SIZE_RECT
        )
        if len(rect):
            self._crop = (rect[0], rect[1])
        else:
            size = cfg.DATA.TEST_CROP_SIZE if is_test else cfg.DATA.TRAIN_CROP_SIZE
            self._crop = (size, size)

    def __len__(self):
        return self._num_videos * self._num_clips

    def _label_of(self, video_id):
        return int(
            np.random.default_rng((video_id, 1)).integers(
                0, self.cfg.MODEL.NUM_CLASSES
            )
        )

    @property
    def _labels(self):
        """Each sample's label (the SSL kNN monitor's bank labels)."""
        return [self._label_of(i // self._num_clips) for i in range(len(self))]

    def __getitem__(self, index):
        """The sample of ``index``, or of (index, phase) in a multigrid
        short cycle's phase 0 or 1: a crop of SHORT_CYCLE_FACTORS[phase] x
        DEFAULT_S (`pmv_tpu/data/synthetic.py:58-71`)."""
        cfg = self.cfg
        short_cycle_idx = None
        if isinstance(index, tuple):
            index, short_cycle_idx = index
        # Label (and base content) must be per-video, not per-view, so
        # multi-view ensembling sees consistent labels across views.
        video_id = index // self._num_clips
        rng = np.random.default_rng(video_id)
        t = cfg.DATA.NUM_FRAMES
        h, w = self._crop
        if short_cycle_idx in [0, 1] and cfg.MULTIGRID.SHORT_CYCLE:
            h = w = int(round(
                cfg.MULTIGRID.SHORT_CYCLE_FACTORS[short_cycle_idx] * cfg.MULTIGRID.DEFAULT_S))
        num_aug = (
            cfg.AUG.NUM_SAMPLE
            if self.mode == "train" and cfg.AUG.ENABLE
            else 1
        )
        shape = (t, h, w, 3) if num_aug == 1 else (num_aug, t, h, w, 3)
        frames = rng.integers(0, 255, shape, dtype=np.uint8)
        label = self._label_of(video_id)
        return {
            "frames": frames,
            "label": label,
            "index": index,
            "time": 0.0,
            "pm": False,
        }
