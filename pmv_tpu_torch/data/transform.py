"""Host-side spatial transforms on numpy video arrays.

Layout convention: channels-last `[T, H, W, C]` float32 (TPU-friendly; the
reference uses `[T, C, H, W]` torch tensors — see
`MViT/slowfast/datasets/transform.py`). Geometric semantics match the
reference exactly, including torch's `F.interpolate(mode='bilinear',
align_corners=False)` (half-pixel sampling with edge clamp), which matters
for checkpoint logit parity.

Randomness is explicit: every stochastic function takes a
`numpy.random.Generator`.
"""

import math

import numpy as np


def resize_bilinear(images, out_h, out_w):
    """Bilinear resize matching torch F.interpolate(align_corners=False).

    images: [T, H, W, C] float array. Separable half-pixel resampling with
    edge clamping, vectorized over frames and channels.
    """
    images = np.asarray(images, dtype=np.float32)
    t, h, w, c = images.shape
    if (h, w) == (out_h, out_w):
        return images

    def axis_weights(in_size, out_size):
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * in_size / out_size - 0.5
        src = np.clip(src, 0, in_size - 1)
        i0 = np.floor(src).astype(np.int64)
        i1 = np.minimum(i0 + 1, in_size - 1)
        frac = (src - i0).astype(np.float32)
        return i0, i1, frac

    # Rows.
    i0, i1, fy = axis_weights(h, out_h)
    images = images[:, i0] * (1 - fy)[None, :, None, None] + images[:, i1] * fy[
        None, :, None, None
    ]
    # Cols.
    j0, j1, fx = axis_weights(w, out_w)
    images = images[:, :, j0] * (1 - fx)[None, None, :, None] + images[:, :, j1] * fx[
        None, None, :, None
    ]
    return images


def random_short_side_scale_jitter(
    images, min_size, max_size, inverse_uniform_sampling=False, rng=None
):
    """Short-side scale jitter (`transform.py:47-101`)."""
    rng = rng or np.random.default_rng()
    if inverse_uniform_sampling:
        size = int(round(1.0 / rng.uniform(1.0 / max_size, 1.0 / min_size)))
    else:
        size = int(round(rng.uniform(min_size, max_size)))
    return short_side_scale(images, size)


def short_side_scale(images, size):
    """Deterministic short-side resize to `size` (keeps aspect)."""
    height, width = images.shape[1], images.shape[2]
    if (width <= height and width == size) or (height <= width and height == size):
        return images
    if width < height:
        new_width = size
        new_height = int(math.floor(float(height) / width * size))
    else:
        new_height = size
        new_width = int(math.floor(float(width) / height * size))
    return resize_bilinear(images, new_height, new_width)


def random_crop(images, size, rng=None):
    """Random square crop (`transform.py:124-157`)."""
    rng = rng or np.random.default_rng()
    if images.shape[1] == size and images.shape[2] == size:
        return images
    height, width = images.shape[1], images.shape[2]
    y_offset = int(rng.integers(0, height - size)) if height > size else 0
    x_offset = int(rng.integers(0, width - size)) if width > size else 0
    return images[:, y_offset : y_offset + size, x_offset : x_offset + size]


def random_crop_rect(images, size, rng=None):
    """Random rectangular crop, size = [h, w] (`transform.py:159-193`)."""
    assert isinstance(size, (list, tuple)) and len(size) == 2
    rng = rng or np.random.default_rng()
    if images.shape[1] == size[0] and images.shape[2] == size[1]:
        return images
    height, width = images.shape[1], images.shape[2]
    y_offset = int(rng.integers(0, height - size[0])) if height > size[0] else 0
    x_offset = int(rng.integers(0, width - size[1])) if width > size[1] else 0
    return images[:, y_offset : y_offset + size[0], x_offset : x_offset + size[1]]


def horizontal_flip(prob, images, rng=None):
    """Flip width axis with probability `prob` (`transform.py:196-228`)."""
    rng = rng or np.random.default_rng()
    if rng.uniform() < prob:
        images = images[:, :, ::-1]
    return images


def uniform_crop(images, size, spatial_idx, scale_size=None):
    """3-position deterministic crop protocol (`transform.py:304-...`).

    spatial_idx 0/1/2 = top/center/bottom for portrait, left/center/right
    for landscape.
    """
    assert spatial_idx in [0, 1, 2]
    if scale_size is not None:
        images = short_side_scale(images, scale_size)
    height, width = images.shape[1], images.shape[2]
    y_offset = int(math.ceil((height - size) / 2))
    x_offset = int(math.ceil((width - size) / 2))
    if height > width:
        if spatial_idx == 0:
            y_offset = 0
        elif spatial_idx == 2:
            y_offset = height - size
    else:
        if spatial_idx == 0:
            x_offset = 0
        elif spatial_idx == 2:
            x_offset = width - size
    return images[:, y_offset : y_offset + size, x_offset : x_offset + size]


def uniform_crop_rect(images, size, spatial_idx, scale_size=None):
    """Rect 3-position crop, size = [h, w] (`transform.py:370-427`)."""
    assert spatial_idx in [0, 1, 2]
    if scale_size is not None:
        images = short_side_scale(images, scale_size)
    height, width = images.shape[1], images.shape[2]
    y_offset = int(math.ceil((height - size[0]) / 2))
    x_offset = int(math.ceil((width - size[1]) / 2))
    if height > width:
        if spatial_idx == 0:
            y_offset = 0
        elif spatial_idx == 2:
            y_offset = height - size[0]
    else:
        if spatial_idx == 0:
            x_offset = 0
        elif spatial_idx == 2:
            x_offset = width - size[1]
    return images[:, y_offset : y_offset + size[0], x_offset : x_offset + size[1]]


def specified_crop(images, size, rel_center_ords=None, center_ords=None):
    """Ratio-positioned square crop for dense eval (`transform.py:231-303`)."""
    height, width = images.shape[1], images.shape[2]
    if rel_center_ords is not None:
        x_offset = int(math.ceil(width * rel_center_ords[0])) - math.floor(size / 2)
        y_offset = int(math.ceil(height * rel_center_ords[1])) - math.floor(size / 2)
    if center_ords is not None:
        x_offset, y_offset = center_ords
    return images[:, y_offset : y_offset + size, x_offset : x_offset + size]


def _get_param_spatial_crop(
    scale, ratio, height, width, rng, num_repeat=10, log_scale=True, switch_hw=False
):
    """Inception-style crop box sampling with PMV 50% H/W switch
    (`transform.py:675-713`)."""
    for _ in range(num_repeat):
        area = height * width
        target_area = rng.uniform(*scale) * area
        if log_scale:
            log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
            aspect_ratio = math.exp(rng.uniform(*log_ratio))
        else:
            aspect_ratio = rng.uniform(*ratio)
        w = int(round(math.sqrt(target_area * aspect_ratio)))
        h = int(round(math.sqrt(target_area / aspect_ratio)))
        if rng.uniform() < 0.5 and switch_hw:
            w, h = h, w
        if 0 < w <= width and 0 < h <= height:
            i = int(rng.integers(0, height - h + 1))
            j = int(rng.integers(0, width - w + 1))
            return i, j, h, w
    # Central fallback.
    in_ratio = float(width) / float(height)
    if in_ratio < min(ratio):
        w = width
        h = int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        h = height
        w = int(round(h * max(ratio)))
    else:
        w = width
        h = height
    i = (height - h) // 2
    j = (width - w) // 2
    return i, j, h, w


def random_resized_crop(
    images,
    target_height,
    target_width,
    scale=(0.8, 1.0),
    ratio=(3.0 / 4.0, 4.0 / 3.0),
    switch_hw=True,
    rng=None,
):
    """Inception-style random resized crop (`transform.py:717-751`)."""
    rng = rng or np.random.default_rng()
    height, width = images.shape[1], images.shape[2]
    i, j, h, w = _get_param_spatial_crop(
        scale, ratio, height, width, rng, switch_hw=switch_hw
    )
    cropped = images[:, i : i + h, j : j + w]
    return resize_bilinear(cropped, target_height, target_width)


def random_resized_crop_with_shift(
    images,
    target_height,
    target_width,
    scale=(0.8, 1.0),
    ratio=(3.0 / 4.0, 4.0 / 3.0),
    switch_hw=False,
    rng=None,
):
    """Motion-shift variant: boxes linearly interpolated first->last frame
    (`transform.py:754-795`)."""
    rng = rng or np.random.default_rng()
    t = images.shape[0]
    height, width = images.shape[1], images.shape[2]
    i, j, h, w = _get_param_spatial_crop(scale, ratio, height, width, rng)
    i_, j_, h_, w_ = _get_param_spatial_crop(scale, ratio, height, width, rng)
    i_s = np.linspace(i, i_, num=t).astype(int)
    j_s = np.linspace(j, j_, num=t).astype(int)
    h_s = np.linspace(h, h_, num=t).astype(int)
    w_s = np.linspace(w, w_, num=t).astype(int)
    out = np.zeros((t, target_height, target_width, images.shape[3]), np.float32)
    for ind in range(t):
        crop = images[
            ind : ind + 1,
            i_s[ind] : i_s[ind] + h_s[ind],
            j_s[ind] : j_s[ind] + w_s[ind],
        ]
        out[ind] = resize_bilinear(crop, target_height, target_width)[0]
    return out


def tensor_normalize(images, mean, std):
    """x/255 (if uint8-ranged) then per-channel (x - mean)/std
    (`datasets/utils.py` tensor_normalize)."""
    images = np.asarray(images, dtype=np.float32)
    if images.max() > 1.0:
        images = images / 255.0
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    return (images - mean) / std
