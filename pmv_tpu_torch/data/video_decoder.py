"""Decode orchestration: clip sampling -> native frame decode.

Replaces `MViT/slowfast/datasets/decoder.py:492-667` (decode) and
`video_container.py` (backend switch). The native FFmpeg library decodes
*only the T sampled frames* of the clip window (the reference decodes the
whole window then index-selects) and can resize during decode via swscale —
the host never touches full-resolution full-window pixel data.
"""

import math

import numpy as np

from pmv_tpu_torch.data import temporal


def decode_clip(
    reader,
    sampling_rate,
    num_frames,
    clip_idx=-1,
    num_clips=10,
    target_fps=30,
    use_offset=False,
    out_w=None,
    out_h=None,
    rng=None,
):
    """Sample one clip and decode its frames.

    reader: an open native `VideoReader`.
    Returns (frames uint8 [T, H, W, 3], start_fraction).
    """
    fps = reader.fps if reader.fps > 0 else target_fps
    video_size = reader.num_frames
    if video_size <= 0:
        video_size = int(reader.duration * fps) if reader.duration > 0 else num_frames
    # Clip extent in *source* frames, fps-normalized (`decoder.py:560-570`).
    clip_size = sampling_rate * num_frames / target_fps * fps
    start_idx, end_idx, frac = temporal.get_start_end_idx(
        video_size, clip_size, clip_idx, num_clips, use_offset=use_offset, rng=rng
    )
    indices = temporal.temporal_sampling_indices(
        video_size, start_idx, end_idx, num_frames
    )
    frames = reader.read_frames(indices, out_w=out_w, out_h=out_h)
    return frames, frac


def decode_multi_clip(
    reader,
    sampling_rate,
    num_frames,
    num_views,
    min_delta=-math.inf,
    max_delta=math.inf,
    target_fps=30,
    use_offset=False,
    out_w=None,
    out_h=None,
    rng=None,
):
    """Sample and decode `num_views` temporal clips with pairwise gap
    constraints (`decoder.py:81-185` get_multiple_start_end_idx) — the
    contrastive multi-clip positives (DATA.TRAIN_CROP_NUM_TEMPORAL).

    Returns (frames uint8 [V, T, H, W, 3], fracs [V]).
    """
    fps = reader.fps if reader.fps > 0 else target_fps
    video_size = reader.num_frames
    if video_size <= 0:
        video_size = (
            int(reader.duration * fps) if reader.duration > 0 else num_frames
        )
    clip_size = sampling_rate * num_frames / target_fps * fps
    se = temporal.get_multiple_start_end_idx(
        video_size,
        [clip_size] * num_views,
        clip_idx=-1,
        num_clips_uniform=1,
        min_delta=min_delta,
        max_delta=max_delta,
        use_offset=use_offset,
        rng=rng,
    )
    views, fracs = [], []
    for v in range(num_views):
        start_idx, end_idx = se[v, 0], se[v, 1]
        indices = temporal.temporal_sampling_indices(
            video_size, start_idx, end_idx, num_frames
        )
        views.append(reader.read_frames(indices, out_w=out_w, out_h=out_h))
        fracs.append(start_idx / max(video_size - clip_size, 1e-6))
    return np.stack(views), np.asarray(fracs, np.float32)


def jitter_scale_dims(height, width, size):
    """Output dims of a short-side resize to `size` (matches
    random_short_side_scale_jitter geometry, `transform.py:73-91`)."""
    if (width <= height and width == size) or (height <= width and height == size):
        return height, width
    if width < height:
        return int(math.floor(float(height) / width * size)), size
    return size, int(math.floor(float(width) / height * size))
