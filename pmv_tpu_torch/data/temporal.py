"""Temporal clip sampling math.

Numerically matches the reference decoder's sampling
(`MViT/slowfast/datasets/decoder.py:17-185`): `get_start_end_idx` (random /
uniform / USE_OFFSET_SAMPLING protocols), constrained multi-clip sampling
`get_multiple_start_end_idx` (min/max delta between clips), and
`temporal_sampling` (linspace index gather).

All functions are host-side (numpy + python RNG) — clip selection is
data-dependent control flow that stays off-device by design.
"""

import math

import numpy as np


def get_start_end_idx(
    video_size, clip_size, clip_idx, num_clips_uniform, use_offset=False, rng=None
):
    """Start/end frame indices of one clip.

    clip_idx == -1: random start in [0, video_size - clip_size].
    clip_idx >= 0: deterministic uniform protocol over num_clips_uniform clips;
    with use_offset, clips are center-aligned (floor-spaced), matching
    `decoder.py:36-78`.

    Returns (start_idx, end_idx, start_fraction).
    """
    delta = max(video_size - clip_size, 0)
    if clip_idx == -1:
        rng = rng or np.random.default_rng()
        start_idx = rng.uniform(0, delta)
    else:
        if use_offset:
            if num_clips_uniform == 1:
                start_idx = math.floor(delta / 2)
            else:
                start_idx = clip_idx * math.floor(delta / (num_clips_uniform - 1))
        else:
            start_idx = delta * clip_idx / num_clips_uniform
    end_idx = start_idx + clip_size - 1
    return start_idx, end_idx, start_idx / delta if delta != 0 else 0.0


def get_multiple_start_end_idx(
    video_size,
    clip_sizes,
    clip_idx,
    num_clips_uniform,
    min_delta=0,
    max_delta=math.inf,
    use_offset=False,
    rng=None,
):
    """Sample one clip per entry of clip_sizes with pairwise gap constraints.

    Retry strategy matches `decoder.py:81-185`: up to 100 inner retries per
    clip to satisfy min/max delta between sorted clip intervals; up to 100
    outer retries keeping the best-goodness failure. Returns an array of
    shape [num_clips, 3]: (start, end, delta_to_previous).
    """
    rng = rng or np.random.default_rng()

    def sample_once():
        se_inds = np.empty((0, 2))
        dt = np.empty((0,))
        for clip_size in clip_sizes:
            for i_try in range(100):
                max_start = max(video_size - clip_size, 0)
                if clip_idx == -1:
                    start_idx = rng.uniform(0, max_start)
                else:
                    if use_offset:
                        if num_clips_uniform == 1:
                            start_idx = math.floor(max_start / 2)
                        else:
                            start_idx = clip_idx * math.floor(
                                max_start / (num_clips_uniform - 1)
                            )
                    else:
                        start_idx = max_start * clip_idx / num_clips_uniform
                end_idx = start_idx + clip_size - 1
                se_new = np.append(se_inds, [[start_idx, end_idx]], axis=0)
                if se_inds.shape[0] < 1:
                    se_inds = se_new
                    break
                se_new = np.sort(se_new, 0)
                t_start, t_end = se_new[:, 0], se_new[:, 1]
                dt = t_start[1:] - t_end[:-1]
                if (any(dt < min_delta) or any(dt > max_delta)) and i_try < 99:
                    continue
                se_inds = se_new
                break
        return se_inds, dt

    goodness = -math.inf
    se_final, dt_final = None, None
    for _ in range(100):
        se_inds, dt = sample_once()
        success = not (any(dt < min_delta) or any(dt > max_delta))
        if success or clip_idx != -1:
            se_final, dt_final = se_inds, dt
            break
        cur_goodness = np.r_[dt[dt < min_delta], -dt[dt > max_delta]].sum()
        if goodness < cur_goodness:
            se_final, dt_final = se_inds, dt
            goodness = cur_goodness

    delta_clips = np.concatenate((np.array([0]), dt_final))
    return np.c_[se_final, delta_clips]


def temporal_sampling_indices(num_input_frames, start_idx, end_idx, num_samples):
    """linspace(start, end, num_samples) frame indices, clamped (decoder.py:17-34)."""
    index = np.linspace(start_idx, end_idx, num_samples)
    return np.clip(index, 0, num_input_frames - 1).astype(np.int64)


def temporal_sampling(frames, start_idx, end_idx, num_samples):
    """Gather num_samples frames uniformly between start and end indices.

    frames: array [T, ...] (any trailing dims).
    """
    idx = temporal_sampling_indices(frames.shape[0], start_idx, end_idx, num_samples)
    return frames[idx]
