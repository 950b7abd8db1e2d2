"""Spatial sampling dispatch with PMV rect-crop and auto-adjust logic.

Matches `MViT/slowfast/datasets/utils.py:120-277`: the PMV-specific
`scale_adjust_short_side_scale_jitter` raises the minimum jitter scale so a
rectangular crop fits extreme aspect ratios, and `spatial_sampling` routes
train (jitter + random/rect/Inception crop + flip), test 3-position protocol,
and dense ratio-positioned crops (spatial_idx == -2).
"""

import math

import numpy as np

from pmv_tpu_torch.data import transform


def scale_adjust_short_side_scale_jitter(min_scale, max_scale, rect_crop_size, h, w):
    """Raise min_scale so a [h_crop, w_crop] rect fits a frame of aspect h:w."""
    if h >= w:
        if rect_crop_size[0] > rect_crop_size[1]:
            min_scale_new = max(min_scale, math.ceil(w / float(h) * rect_crop_size[0]))
        else:
            min_scale_new = max(min_scale, rect_crop_size[1])
    else:
        if rect_crop_size[0] > rect_crop_size[1]:
            min_scale_new = max(min_scale, rect_crop_size[0])
        else:
            min_scale_new = max(min_scale, math.ceil(h / float(w) * rect_crop_size[1]))
    return min_scale_new, max_scale


def spatial_sampling(
    frames,
    spatial_idx=-1,
    min_scale=256,
    max_scale=320,
    crop_size=224,
    random_horizontal_flip=True,
    inverse_uniform_sampling=False,
    aspect_ratio=None,
    scale=None,
    motion_shift=False,
    rel_center_ratio=None,
    switch_hw=True,
    rect_crop_size=(),
    auto_adjust=False,
    rng=None,
):
    """Spatial sampling on [T, H, W, C] frames.

    spatial_idx: -1 random train sampling; 0/1/2 deterministic 3-crop test
    protocol; -2 dense ratio-positioned crop (needs rel_center_ratio).
    """
    rng = rng or np.random.default_rng()
    rect_crop_size = list(rect_crop_size) if len(rect_crop_size) else None
    assert spatial_idx in [-2, -1, 0, 1, 2]

    if spatial_idx == -1:
        if aspect_ratio is None and scale is None:
            if rect_crop_size is not None and auto_adjust:
                min_scale, max_scale = scale_adjust_short_side_scale_jitter(
                    min_scale, max_scale, rect_crop_size,
                    frames.shape[1], frames.shape[2],
                )
            frames = transform.random_short_side_scale_jitter(
                frames, min_scale, max_scale,
                inverse_uniform_sampling=inverse_uniform_sampling, rng=rng,
            )
            if rect_crop_size is None:
                frames = transform.random_crop(frames, crop_size, rng=rng)
            else:
                frames = transform.random_crop_rect(frames, rect_crop_size, rng=rng)
        else:
            transform_func = (
                transform.random_resized_crop_with_shift
                if motion_shift
                else transform.random_resized_crop
            )
            th, tw = (
                (crop_size, crop_size)
                if rect_crop_size is None
                else (rect_crop_size[0], rect_crop_size[1])
            )
            frames = transform_func(
                images=frames, target_height=th, target_width=tw,
                scale=scale, ratio=aspect_ratio, switch_hw=switch_hw, rng=rng,
            )
        if random_horizontal_flip:
            frames = transform.horizontal_flip(0.5, frames, rng=rng)
    else:
        if rect_crop_size is not None and auto_adjust:
            min_scale, max_scale = scale_adjust_short_side_scale_jitter(
                min_scale, max_scale, rect_crop_size,
                frames.shape[1], frames.shape[2],
            )
            max_scale = min_scale
        assert len({min_scale, max_scale}) == 1
        frames = transform.short_side_scale(frames, min_scale)
        if spatial_idx == -2:
            if rect_crop_size is not None and auto_adjust:
                raise NotImplementedError(
                    "dense crops with rect auto-adjust are unsupported "
                    "(parity with datasets/utils.py:258)"
                )
            assert rel_center_ratio is not None
            new_h, new_w = frames.shape[1], frames.shape[2]
            offset_h = math.ceil((new_h - crop_size) * rel_center_ratio[0])
            offset_w = math.ceil((new_w - crop_size) * rel_center_ratio[1])
            offset_h = min(max(offset_h, 0), new_h - crop_size)
            offset_w = min(max(offset_w, 0), new_w - crop_size)
            frames = transform.specified_crop(
                frames, crop_size, center_ords=[offset_w, offset_h]
            )
        else:
            if rect_crop_size is None:
                frames = transform.uniform_crop(frames, crop_size, spatial_idx)
            else:
                frames = transform.uniform_crop_rect(
                    frames, rect_crop_size, spatial_idx
                )
    return np.ascontiguousarray(frames)
