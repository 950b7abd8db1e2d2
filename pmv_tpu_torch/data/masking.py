"""Blockwise mask generators for masked pre-training (MaskFeat).

The port's own copy of `pmv_tpu/data/masking.py` (a numpy module), itself
a port of `MViT/slowfast/datasets/transform.py:984-1160`
(``MaskingGenerator``, ``MaskingGenerator3D``, BEiT-style block masking)
and of the dataset's dispatch `kinetics.py:542-578` (``_gen_mask``). The
generators draw from the ``np.random.Generator`` they are given, draw for
draw as the JAX package's, so that one seed gives both packages the same
mask. A mask is a small [t, h, w] int grid a sample, made on the host by
the loader (AUG.GEN_MASK_LOADER); the train step takes it flattened to
booleans.
"""

import math

import numpy as np


class MaskingGenerator:
    """2-D block masking over an (H, W) patch window."""

    def __init__(
        self,
        mask_window_size,
        num_masking_patches,
        min_num_patches=16,
        max_num_patches=None,
        min_aspect=0.3,
        max_aspect=None,
        rng=None,
    ):
        if not isinstance(mask_window_size, (list, tuple)):
            mask_window_size = (mask_window_size,) * 2
        self.height, self.width = mask_window_size
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (
            num_masking_patches if max_num_patches is None else max_num_patches
        )
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))
        self.rng = rng or np.random.default_rng()

    def _mask(self, mask, max_mask_patches):
        delta = 0
        for _ in range(10):
            target_area = self.rng.uniform(
                min(self.min_num_patches, max_mask_patches), max_mask_patches
            )
            aspect_ratio = math.exp(self.rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect_ratio)))
            w = int(round(math.sqrt(target_area / aspect_ratio)))
            if w < self.width and h < self.height:
                top = int(self.rng.integers(0, self.height - h + 1))
                left = int(self.rng.integers(0, self.width - w + 1))
                region = mask[top : top + h, left : left + w]
                num_masked = int(region.sum())
                if 0 < h * w - num_masked <= max_mask_patches:
                    delta = int((region == 0).sum())
                    region[...] = 1
                if delta > 0:
                    break
        return delta

    def __call__(self):
        mask = np.zeros((self.height, self.width), dtype=np.int64)
        mask_count = 0
        while mask_count < self.num_masking_patches:
            max_mask_patches = min(
                self.num_masking_patches - mask_count, self.max_num_patches
            )
            delta = self._mask(mask, max_mask_patches)
            if delta == 0:
                break
            mask_count += delta
        return mask


class MaskingGenerator3D:
    """3-D (T, H, W) block masking: random spatial block extruded over a
    random temporal extent."""

    def __init__(
        self,
        mask_window_size,
        num_masking_patches,
        min_num_patches=16,
        max_num_patches=None,
        min_aspect=0.3,
        max_aspect=None,
        rng=None,
    ):
        self.temporal, self.height, self.width = mask_window_size
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (
            num_masking_patches if max_num_patches is None else max_num_patches
        )
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))
        self.rng = rng or np.random.default_rng()

    def _mask(self, mask, max_mask_patches):
        delta = 0
        for _ in range(100):
            target_area = self.rng.uniform(
                self.min_num_patches, self.max_num_patches
            )
            aspect_ratio = math.exp(self.rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect_ratio)))
            w = int(round(math.sqrt(target_area / aspect_ratio)))
            t = int(self.rng.integers(1, self.temporal + 1))
            if w < self.width and h < self.height:
                top = int(self.rng.integers(0, self.height - h + 1))
                left = int(self.rng.integers(0, self.width - w + 1))
                front = int(self.rng.integers(0, self.temporal - t + 1))
                region = mask[
                    front : front + t, top : top + h, left : left + w
                ]
                num_masked = int(region.sum())
                if 0 < h * w * t - num_masked <= max_mask_patches:
                    delta = int((region == 0).sum())
                    region[...] = 1
                if delta > 0:
                    break
        return delta

    def __call__(self):
        mask = np.zeros(
            (self.temporal, self.height, self.width), dtype=np.int64
        )
        mask_count = 0
        while mask_count < self.num_masking_patches:
            delta = self._mask(mask, self.num_masking_patches - mask_count)
            if delta == 0:
                break
            mask_count += delta
        return mask


def gen_mask(cfg, rng=None):
    """Per-sample mask on the AUG.MASK_WINDOW_SIZE token grid
    (`kinetics.py:542-578` _gen_mask dispatch). Returns [T, H, W] int."""
    rng = rng or np.random.default_rng()
    window = cfg.AUG.MASK_WINDOW_SIZE
    if cfg.AUG.MASK_TUBE:
        num = round(np.prod(window) * cfg.AUG.MASK_RATIO)
        gen = MaskingGenerator(
            mask_window_size=window[1:],
            num_masking_patches=num,
            max_num_patches=None,
            min_num_patches=num // 5,
            rng=rng,
        )
        # 2-D mask tubed across time (reference tiles x8).
        return np.tile(gen()[None], (window[0], 1, 1))
    if cfg.AUG.MASK_FRAMES:
        mask = np.zeros(window, dtype=np.int64)
        n_mask = round(window[0] * cfg.AUG.MASK_RATIO)
        idx = rng.choice(window[0], size=n_mask, replace=False)
        mask[idx] = 1
        return mask
    num = round(np.prod(window) * cfg.AUG.MASK_RATIO)
    max_mask = int(np.prod(window[1:]))
    gen = MaskingGenerator3D(
        mask_window_size=window,
        num_masking_patches=num,
        max_num_patches=max_mask,
        min_num_patches=max_mask // 5,
        rng=rng,
    )
    return gen()
