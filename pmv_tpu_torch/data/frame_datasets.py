"""Frame-list datasets: SSv2, Something-Something V1 (Sth), Charades and
ImageNet.

The port's copy of `pmv_tpu/data/frame_datasets.py` (the reference's
`MViT/slowfast/datasets/{ssv2,charades,imagenet}.py` and UniFormer's
`sth.py`): JPEG frames decode through PIL, the crops through the port's
``data/spatial.py``; the host stops at uint8 crops [T, H, W, C], and the
train step augments on the device.

Frame lists (`datasets/utils.py:327-367` load_image_lists): a header line
``original_vido_id video_id frame_id path labels``, then one space-separated
row a frame; ``path`` is relative to DATA.PATH_PREFIX, ``labels`` a quoted,
comma-separated list of class ids (Charades' per-frame labels; empty for
SSv2, whose labels come from its JSON files). Sth reads
``DATA.LABEL_PATH_TEMPLATE.format(split)`` rows ``dir num_frames label``
and the frames ``DATA.IMAGE_TEMPLATE`` in each directory; ImageNet
``<split>.txt`` rows ``relpath label``.

Every random draw of a sample comes from one ``np.random.Generator`` seeded
with (RNG_SEED, epoch, index), as the port's Kinetics draws; the JAX
package draws from an unseeded generator. ``_seq_frames(index, rng)`` and
``_sample_and_pack(frames, index, label, rng)`` keep the JAX signatures and
draws, so that one generator handed to both packages gives the same sample.
Test mode draws nothing.

A multigrid short cycle's ``(index, phase)`` index raises
NotImplementedError: the JAX package's frame datasets index their lists with
it and fail, so neither package runs MULTIGRID.SHORT_CYCLE on them.
"""

import json
import os
from collections import defaultdict

import numpy as np

from pmv_tpu_torch.data import spatial
from pmv_tpu_torch.data.build import DATASET_REGISTRY
from pmv_tpu_torch.utils import logging as pmv_logging

logger = pmv_logging.get_logger(__name__)


def load_image_lists(frame_list_file, prefix=""):
    """-> (image paths [video][frame], labels [video][frame], video names)."""
    image_paths = defaultdict(list)
    labels = defaultdict(list)
    with open(frame_list_file, "r") as f:
        header = f.readline()
        if not header.startswith("original_vido_id"):
            raise ValueError(f"bad frame list header: {header!r}")
        for line in f:
            row = line.split()
            if len(row) != 5:
                raise ValueError(f"bad frame-list row: {line!r}")
            video_name = row[0]
            path = row[3] if prefix == "" else os.path.join(prefix, row[3])
            image_paths[video_name].append(path)
            frame_labels = row[-1].replace('"', "")
            labels[video_name].append(
                [int(x) for x in frame_labels.split(",")] if frame_labels else []
            )
    keys = list(image_paths.keys())
    return [image_paths[k] for k in keys], [labels[k] for k in keys], keys


def _decode_rgb(path):
    """One JPEG -> uint8 [H, W, 3]."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img if img.mode == "RGB" else img.convert("RGB"))


def _load_jpeg_frames(paths):
    """Decode JPEG paths -> float32 [T, H, W, 3] (the JAX package's values:
    each frame's RGB bytes as float32), written into one array as they
    decode."""
    frames = None
    for i, p in enumerate(paths):
        rgb = _decode_rgb(p)
        if frames is None:
            frames = np.empty((len(paths), *rgb.shape), np.float32)
        elif rgb.shape != frames.shape[1:]:
            raise ValueError(f"{p} is {rgb.shape[:2]}, the clip's first frame "
                             f"{frames.shape[1:3]}")
        frames[i] = rgb
    return frames


def _packed(frames, index, label):
    # Clipped and cast to uint8 in one pass: the JAX package's
    # clip(...).astype(uint8), without the float32 copy between.
    out = np.empty(frames.shape, np.uint8)
    return {
        "frames": np.clip(frames, 0, 255, out=out, casting="unsafe"),
        "label": label,
        "index": index,
        "time": 0.0,
        "pm": False,
    }


class _Seeded:
    """The per-sample generator of (RNG_SEED, epoch, index), and the refusal
    of the short cycle's tuple index."""

    epoch = 0

    def _set_epoch_num(self, epoch):
        self.epoch = epoch

    def _rng(self, index):
        if isinstance(index, tuple):
            raise NotImplementedError(
                f"{type(self).__name__} takes no multigrid short-cycle index {index}: "
                "MULTIGRID.SHORT_CYCLE runs on Kinetics and Synthetic only, as in the "
                "JAX package"
            )
        return np.random.default_rng((self.cfg.RNG_SEED, self.epoch, index))


class _FrameListBase(_Seeded):
    """Shared multi-view bookkeeping + spatial sampling."""

    def __init__(self, cfg, mode):
        if mode not in ["train", "val", "test"]:
            raise ValueError(f"mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self._num_clips = (
            1 if mode in ["train", "val"]
            else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        )

    def __len__(self):
        return len(self._path_to_videos)

    @property
    def num_videos(self):
        return len(self)

    def _spatial_params(self, index):
        cfg = self.cfg
        if self.mode in ["train", "val"]:
            return (-1, cfg.DATA.TRAIN_JITTER_SCALES[0], cfg.DATA.TRAIN_JITTER_SCALES[1],
                    cfg.DATA.TRAIN_CROP_SIZE)
        spatial_idx = (
            self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
            if cfg.TEST.NUM_SPATIAL_CROPS > 1
            else 1
        )
        return spatial_idx, cfg.DATA.TEST_CROP_SIZE, cfg.DATA.TEST_CROP_SIZE, \
            cfg.DATA.TEST_CROP_SIZE

    def _sample_and_pack(self, frames, index, label, rng):
        cfg = self.cfg
        spatial_idx, min_scale, max_scale, crop_size = self._spatial_params(index)
        scl = list(cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE)
        asp = list(cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE)
        frames = spatial.spatial_sampling(
            frames,
            spatial_idx=spatial_idx,
            min_scale=min_scale,
            max_scale=max_scale,
            crop_size=crop_size,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP and self.mode == "train",
            aspect_ratio=asp if (self.mode == "train" and asp) else None,
            scale=scl if (self.mode == "train" and scl) else None,
            rng=rng,
        )
        return _packed(frames, index, label)

    def _unroll(self, items):
        """Each video's entry repeated for its test views."""
        return [item for item in items for _ in range(self._num_clips)]


@DATASET_REGISTRY.register(name="Ssv2")
class Ssv2(_FrameListBase):
    """Something-Something V2 (`ssv2.py`): JSON labels + frame lists;
    segment-based temporal sampling (`ssv2.py:159-180`)."""

    def __init__(self, cfg, mode):
        super().__init__(cfg, mode)
        d = cfg.DATA.PATH_TO_DATA_DIR
        with open(os.path.join(d, "something-something-v2-labels.json")) as f:
            label_dict = json.load(f)
        split = "train" if mode == "train" else "validation"
        with open(os.path.join(d, f"something-something-v2-{split}.json")) as f:
            label_json = json.load(f)
        name_to_label = {
            video["id"]: int(label_dict[video["template"].replace("[", "").replace("]", "")])
            for video in label_json
        }
        csv_split = "train" if mode == "train" else "val"
        paths, _, keys = load_image_lists(os.path.join(d, f"{csv_split}.csv"),
                                          cfg.DATA.PATH_PREFIX)
        kept = [(p, name_to_label[k]) for p, k in zip(paths, keys) if k in name_to_label]
        self._path_to_videos = self._unroll([p for p, _ in kept])
        self._labels = self._unroll([label for _, label in kept])
        self._spatial_temporal_idx = [i % self._num_clips for i in range(len(self._labels))]
        logger.info("Constructed SSv2 %s: %d clips", mode, len(self._labels))

    def _seq_frames(self, index, rng):
        """Per-segment sampling (`ssv2.py:159-180`)."""
        num_frames = self.cfg.DATA.NUM_FRAMES
        video_length = len(self._path_to_videos[index])
        seg_size = float(video_length - 1) / num_frames
        seq = []
        for i in range(num_frames):
            start = int(np.round(seg_size * i))
            end = int(np.round(seg_size * (i + 1)))
            if self.mode == "train":
                seq.append(int(rng.integers(start, end + 1)))
            else:
                seq.append((start + end) // 2)
        return seq

    def __getitem__(self, index):
        rng = self._rng(index)
        seq = self._seq_frames(index, rng)
        frames = _load_jpeg_frames([self._path_to_videos[index][i] for i in seq])
        return self._sample_and_pack(frames, index, self._labels[index], rng)


@DATASET_REGISTRY.register(name="Sth")
class Sth(_FrameListBase):
    """Something-Something V1, UniFormer flavor
    (`Uniformer/slowfast/datasets/sth.py:25-376`): space-separated rows
    ``dir num_frames label`` named by ``DATA.LABEL_PATH_TEMPLATE.format(split)``
    (split "train" or "validation"; the template's default "{}{}.csv" takes
    two fields, so it raises IndexError here as in the JAX package); frames
    in per-video directories named by DATA.IMAGE_TEMPLATE; TSN-style
    segment sampling whose test position depends on the ensemble view
    (`sth.py:134-161`)."""

    def __init__(self, cfg, mode):
        super().__init__(cfg, mode)
        split = "train" if mode == "train" else "validation"
        path_to_file = os.path.join(cfg.DATA.PATH_TO_DATA_DIR,
                                    cfg.DATA.LABEL_PATH_TEMPLATE.format(split))
        rows = []
        with open(path_to_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 3:
                    rows.append((os.path.join(cfg.DATA.PATH_PREFIX, parts[0]), int(parts[1]),
                                 int(parts[2])))
        rows = self._unroll(rows)
        self._path_to_videos = [r[0] for r in rows]
        self._num_frames = [r[1] for r in rows]
        self._labels = [r[2] for r in rows]
        self._spatial_temporal_idx = [i % self._num_clips for i in range(len(self._labels))]
        logger.info("Constructed Sth %s: %d clips", mode, len(self._labels))

    def _seq_frames(self, index, rng):
        """Segment sampling (`sth.py:134-161`): train picks a random frame
        per segment; test picks a view-dependent deterministic position."""
        cfg = self.cfg
        num_frames = cfg.DATA.NUM_FRAMES
        video_length = self._num_frames[index]
        seg_size = float(video_length - 1) / num_frames
        seq = []
        if self.mode in ["train", "val"]:
            for i in range(num_frames):
                start = int(np.round(seg_size * i))
                end = int(np.round(seg_size * (i + 1)))
                seq.append(int(rng.integers(start, end + 1)))
        else:
            t_idx = self._spatial_temporal_idx[index] // cfg.TEST.NUM_SPATIAL_CROPS
            duration = seg_size / (cfg.TEST.NUM_ENSEMBLE_VIEWS + 1)
            for i in range(num_frames):
                start = int(np.round(seg_size * i))
                seq.append(start + int(duration * (t_idx + 1)))
        return [min(max(i, 0), video_length - 1) for i in seq]

    def __getitem__(self, index):
        rng = self._rng(index)
        seq = self._seq_frames(index, rng)
        template = os.path.join(self._path_to_videos[index], self.cfg.DATA.IMAGE_TEMPLATE)
        # The raw segment indices go into IMAGE_TEMPLATE, as the reference
        # formats them (`sth.py:229-237`).
        frames = _load_jpeg_frames([template.format(i) for i in seq])
        return self._sample_and_pack(frames, index, self._labels[index], rng)


@DATASET_REGISTRY.register(name="Charades")
class Charades(_FrameListBase):
    """Charades (`charades.py`): frame lists with per-frame multi-labels;
    strided window sampling; the label is the union over the sampled
    window, a float32 vector of MODEL.NUM_CLASSES."""

    def __init__(self, cfg, mode):
        super().__init__(cfg, mode)
        split = "train" if mode == "train" else "val"
        paths, labels, _ = load_image_lists(
            os.path.join(cfg.DATA.PATH_TO_DATA_DIR, f"{split}.csv"), cfg.DATA.PATH_PREFIX)
        self._path_to_videos = self._unroll(paths)
        self._frame_labels = self._unroll(labels)
        self._spatial_temporal_idx = [
            i % self._num_clips for i in range(len(self._path_to_videos))]
        logger.info("Constructed Charades %s: %d clips", mode, len(self._path_to_videos))

    def _seq_frames(self, index, rng):
        """Strided clip window (`charades.py:113-152`)."""
        cfg = self.cfg
        num_frames = cfg.DATA.NUM_FRAMES
        sampling_rate = cfg.DATA.SAMPLING_RATE
        video_length = len(self._path_to_videos[index])
        clip_length = (num_frames - 1) * sampling_rate + 1
        if self.mode in ["train", "val"]:
            if clip_length > video_length:
                start = int(rng.integers(video_length - clip_length, 1))
            else:
                start = int(rng.integers(0, video_length - clip_length + 1))
        else:
            t_idx = self._spatial_temporal_idx[index] // cfg.TEST.NUM_SPATIAL_CROPS
            gap = float(max(video_length - clip_length, 0)) / max(
                cfg.TEST.NUM_ENSEMBLE_VIEWS - 1, 1)
            start = int(round(gap * t_idx))
        return [max(min(start + i * sampling_rate, video_length - 1), 0)
                for i in range(num_frames)]

    def __getitem__(self, index):
        rng = self._rng(index)
        seq = self._seq_frames(index, rng)
        frames = _load_jpeg_frames([self._path_to_videos[index][i] for i in seq])
        label = np.zeros((self.cfg.MODEL.NUM_CLASSES,), np.float32)
        for i in seq:
            label[self._frame_labels[index][i]] = 1.0
        return self._sample_and_pack(frames, index, label, rng)


@DATASET_REGISTRY.register(name="Imagenet")
class Imagenet(_Seeded):
    """ImageNet (`imagenet.py`): ``<split>.txt`` rows ``relpath label``;
    each image a 1-frame video, so the shared pipeline applies. The test
    split reads ``val.txt``."""

    def __init__(self, cfg, mode):
        if mode not in ["train", "val", "test"]:
            raise ValueError(f"mode {mode!r}")
        self.cfg = cfg
        self.mode = "val" if mode == "test" else mode
        self._paths, self._labels = [], []
        with open(os.path.join(cfg.DATA.PATH_TO_DATA_DIR, f"{self.mode}.txt")) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    self._paths.append(os.path.join(cfg.DATA.PATH_PREFIX, parts[0]))
                    self._labels.append(int(parts[1]))
        self._num_clips = 1
        self._spatial_temporal_idx = [0] * len(self._paths)

    def __len__(self):
        return len(self._paths)

    @property
    def num_videos(self):
        return len(self)

    def _sample_and_pack(self, frames, index, label, rng):
        cfg = self.cfg
        if self.mode == "train":
            scl = list(cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE) or [0.08, 1.0]
            asp = list(cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE) or [0.75, 4 / 3]
            frames = spatial.spatial_sampling(
                frames, spatial_idx=-1, crop_size=cfg.DATA.TRAIN_CROP_SIZE,
                aspect_ratio=asp, scale=scl, rng=rng,
            )
        else:
            frames = spatial.spatial_sampling(
                frames, spatial_idx=1, min_scale=cfg.DATA.TEST_CROP_SIZE,
                max_scale=cfg.DATA.TEST_CROP_SIZE, crop_size=cfg.DATA.TEST_CROP_SIZE, rng=rng,
            )
        return _packed(frames, index, label)

    def __getitem__(self, index):
        rng = self._rng(index)
        frames = _load_jpeg_frames([self._paths[index]])
        return self._sample_and_pack(frames, index, self._labels[index], rng)


# PyTorchVideo-wrapper dataset names (`ptv_datasets.py:311,454`) alias the
# same datasets.
DATASET_REGISTRY.register(Ssv2, name="Ptvssv2")
DATASET_REGISTRY.register(Charades, name="Ptvcharades")
