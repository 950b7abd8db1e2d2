"""AVA action-detection dataset (`MViT/slowfast/datasets/ava_dataset.py`
and `ava_helper.py`).

The port's copy of `pmv_tpu/data/ava.py`. Frame-based: per-video JPEG
frame lists (the shared ``original_vido_id video_id frame_id path labels``
format, ``frame_datasets.load_image_lists``) and keyframe annotations. Each
sample is a clip centred on an annotated keyframe, with its person boxes in
the crop's pixels and multi-hot action labels, padded to ``MAX_BOXES`` so
that every batch has one shape.

Annotation CSV rows (AVA v2.2): ``video_id,sec,x1,y1,x2,y2,action_id,person``
with box coordinates in [0, 1]; a predicted-box list may carry a score in
the 8th column, and rows under AVA.DETECTION_SCORE_THRESH are dropped.

Every random draw of a sample comes from one ``np.random.Generator``
seeded with (RNG_SEED, epoch, index), as the port's other datasets draw;
the JAX package draws from an unseeded ``np.random.default_rng()`` inside
``__getitem__`` (`pmv_tpu/data/ava.py:219`), in the same order as here, so
that one generator handed to both gives the same sample.

Val and test centre-crop to DATA.TEST_CROP_SIZE, as the JAX package does:
the reference tests on the full short-side-scaled frame (ROADMAP.md records
the difference). AVA.TRAIN_USE_COLOR_AUGMENTATION jitters the clip here on
the host and again in the train step's preprocessing, as the JAX package
does (``engine/steps.py``; ROADMAP.md).
"""

import os

import numpy as np

from pmv_tpu_torch.data import transform
from pmv_tpu_torch.data.build import DATASET_REGISTRY
from pmv_tpu_torch.data.frame_datasets import _Seeded, _load_jpeg_frames, load_image_lists
from pmv_tpu_torch.utils import logging as pmv_logging

logger = pmv_logging.get_logger(__name__)

_AVA_FPS = 30
_AVA_VALID_SECS = (902, 1798)
MAX_BOXES = 16


def _color_augmentation(frames, cfg, rng):
    """The reference's AVA train colour augmentation on [T, H, W, 3] RGB
    frames in [0, 255] (`ava_dataset.py:202-217`, `cv2_transform.py:240-298,
    636-741`): unless AVA.TRAIN_PCA_JITTER_ONLY, brightness, contrast and
    saturation blends in a random order (one alpha in 1 +- 0.4 a clip),
    then AlexNet's PCA lighting jitter (alphastd 0.1,
    DATA.TRAIN_PCA_EIGVAL and EIGVEC), on the [0, 255] scale."""
    f = frames.astype(np.float32)

    def gray(x):
        g = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
        return g[..., None].repeat(3, axis=-1)

    if not cfg.AVA.TRAIN_PCA_JITTER_ONLY:
        ops = ["brightness", "contrast", "saturation"]
        for name in [ops[i] for i in rng.permutation(3)]:
            alpha = 1.0 + rng.uniform(-0.4, 0.4)
            if name == "brightness":
                target = np.zeros_like(f)
            elif name == "contrast":
                target = np.full_like(f, gray(f).mean())
            else:
                target = gray(f)
            f = f * alpha + target * (1.0 - alpha)
    alpha = rng.normal(0, 0.1, size=(1, 3)).astype(np.float32)
    eigvec = np.asarray(cfg.DATA.TRAIN_PCA_EIGVEC, np.float32)
    eigval = np.asarray(cfg.DATA.TRAIN_PCA_EIGVAL, np.float32).reshape(1, 3)
    rgb = np.sum(eigvec * alpha * eigval, axis=1)  # [3], RGB order
    return f + rgb * 255.0


def _scale_box_ratio(height, width, size):
    """The one factor the reference scales boxes by for a short-side resize
    to ``size`` (`cv2_transform.py:29-74,106-131`): the long side's ratio
    floor(long / short x size) / long, which the floor makes differ from
    size / short by under a pixel; 1 when no resize runs."""
    if (width <= height and width == size) or (height <= width and height == size):
        return 1.0
    if width < height:
        return float(int(np.floor(float(height) / width * size))) / height
    return float(int(np.floor(float(width) / height * size))) / width


def _clip_boxes(boxes, height, width):
    """Clamp to [0, dim - 1] (`cv2_transform.py:9-26`), in place."""
    boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0.0, width - 1.0)
    boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0.0, height - 1.0)
    return boxes


def _flip_boxes(boxes, im_width):
    """x -> w - x - 1, x1 and x2 swapped (`cv2_transform.py:365-378`)."""
    flipped = boxes.copy()
    flipped[:, 0] = im_width - boxes[:, 2] - 1
    flipped[:, 2] = im_width - boxes[:, 0] - 1
    return flipped


def get_sequence(center_idx, half_len, sample_rate, num_frames):
    """A clip's frame indices around a keyframe, clamped into the video
    (`datasets/utils.py` get_sequence)."""
    seq = range(center_idx - half_len, center_idx + half_len, sample_rate)
    return [min(max(i, 0), num_frames - 1) for i in seq]


def parse_bboxes_file(path, is_gt, detect_thresh, all_boxes=None):
    """One box-list CSV (`ava_helper.py` parse_bboxes_file), rows
    ``video_id,sec,x1,y1,x2,y2,label[,score]``, into
    video -> sec -> {box: [box, [labels]]} (the labels of a box merged),
    added to ``all_boxes`` where given."""
    if all_boxes is None:
        all_boxes = {}
    with open(path) as f:
        for line in f:
            row = line.strip().split(",")
            if len(row) < 7:
                continue
            if not is_gt and len(row) == 8:
                try:
                    if float(row[7]) < detect_thresh:
                        continue
                except ValueError:
                    pass
            video, sec = row[0], int(float(row[1]))
            box = list(map(float, row[2:6]))
            label = -1 if row[6] == "" else int(row[6])
            boxes = all_boxes.setdefault(video, {}).setdefault(sec, {})
            entry = boxes.setdefault(tuple(box), [box, []])
            if label != -1:
                entry[1].append(label)
    return all_boxes


def load_boxes_and_labels(cfg, mode):
    """The keyframes' annotations, video -> sec -> [(box, [labels])]: the
    train split's ground-truth and predicted lists, or the test split's
    predicted ones."""
    files = (list(cfg.AVA.TRAIN_GT_BOX_LISTS) + list(cfg.AVA.TRAIN_PREDICT_BOX_LISTS)
             if mode == "train" else list(cfg.AVA.TEST_PREDICT_BOX_LISTS))
    all_boxes = {}
    for filename in files:
        parse_bboxes_file(os.path.join(cfg.AVA.ANNOTATION_DIR, filename),
                          filename in cfg.AVA.TRAIN_GT_BOX_LISTS,
                          cfg.AVA.DETECTION_SCORE_THRESH, all_boxes)
    return {video: {sec: list(d.values()) for sec, d in secs.items()}
            for video, secs in all_boxes.items()}


@DATASET_REGISTRY.register(name="Ava")
class Ava(_Seeded):
    """AVA keyframe detection (`ava_dataset.py`, cv2 backend). A sample:
    uint8 "frames" [T, crop, crop, 3]; "boxes" [MAX_BOXES, 4] in the crop's
    pixels, "box_mask" [MAX_BOXES], multi-hot "label" [MAX_BOXES,
    NUM_CLASSES] (action ids as class columns, as in the JAX package),
    "ori_boxes" [MAX_BOXES, 4] in [0, 1] and "metadata" [video_idx, sec].
    Train: inverse-uniform short-side scale in DATA.TRAIN_JITTER_SCALES,
    a random crop, a flip by a coin, the optional colour augmentation; val
    and test: scale to the crop, the centre crop (ceil offsets), a flip
    with AVA.TEST_FORCE_FLIP."""

    def __init__(self, cfg, mode):
        if mode not in ["train", "val", "test"]:
            raise ValueError(f"mode {mode!r}")
        self.cfg = cfg
        self.mode = "train" if mode == "train" else "test"
        self._sample_rate = cfg.DATA.SAMPLING_RATE
        self._seq_len = cfg.DATA.NUM_FRAMES * self._sample_rate
        self._load()

    def _load(self):
        cfg = self.cfg
        lists = cfg.AVA.TRAIN_LISTS if self.mode == "train" else cfg.AVA.TEST_LISTS
        paths, keys = [], []
        for fl in lists:
            p, _, k = load_image_lists(os.path.join(cfg.AVA.FRAME_LIST_DIR, fl),
                                       cfg.AVA.FRAME_DIR)
            paths += p
            keys += k
        self._image_paths = paths
        self._video_names = keys
        name_to_idx = {n: i for i, n in enumerate(keys)}
        self._keyframe_indices = []  # (video_idx, sec, centre frame)
        self._keyframe_boxes = []
        for video, secs in load_boxes_and_labels(cfg, self.mode).items():
            if video not in name_to_idx:
                continue
            vi = name_to_idx[video]
            for sec, box_list in sorted(secs.items()):
                if not box_list:
                    continue
                center = (sec - _AVA_VALID_SECS[0]) * _AVA_FPS
                center = min(max(center, 0), len(self._image_paths[vi]) - 1)
                self._keyframe_indices.append((vi, sec, center))
                self._keyframe_boxes.append(box_list)
        logger.info("Constructed AVA %s: %d keyframes over %d videos",
                    self.mode, len(self._keyframe_indices), len(keys))

    def __len__(self):
        return len(self._keyframe_indices)

    @property
    def num_videos(self):
        return len(self)

    def __getitem__(self, idx):
        return self._sample(idx, self._rng(idx))

    def _sample(self, idx, rng):
        """Sample ``idx`` with its draws from ``rng`` (the JAX package's
        order)."""
        cfg = self.cfg
        video_idx, sec, center_idx = self._keyframe_indices[idx]
        seq = get_sequence(center_idx, self._seq_len // 2, self._sample_rate,
                           len(self._image_paths[video_idx]))
        frames = _load_jpeg_frames([self._image_paths[video_idx][i] for i in seq])
        box_list = self._keyframe_boxes[idx]
        boxes = np.array([b[0] for b in box_list], np.float32)[:, :4]
        labels = [b[1] for b in box_list]

        # The boxes in the decoded frame's pixels, clipped, then carried
        # through each geometric op (`ava_dataset.py:113-243`).
        crop = cfg.DATA.TRAIN_CROP_SIZE if self.mode == "train" else cfg.DATA.TEST_CROP_SIZE
        h0, w0 = frames.shape[1:3]
        px = _clip_boxes(boxes * np.array([w0, h0, w0, h0], np.float32), h0, w0)
        if self.mode == "train":
            lo, hi = cfg.DATA.TRAIN_JITTER_SCALES
            scale = int(round(1.0 / rng.uniform(1.0 / hi, 1.0 / lo)))
            px *= _scale_box_ratio(h0, w0, scale)
            frames = transform.short_side_scale(frames, scale)
            h, w = frames.shape[1:3]
            # randint's exclusive bound (`cv2_transform.py:424-428`).
            y0 = int(rng.integers(0, h - crop)) if h > crop else 0
            x0 = int(rng.integers(0, w - crop)) if w > crop else 0
            frames = frames[:, y0:y0 + crop, x0:x0 + crop]
            px -= np.array([x0, y0, x0, y0], np.float32)
            if rng.uniform() < 0.5:
                frames = frames[:, :, ::-1]
                px = _flip_boxes(px, crop)
            if cfg.AVA.TRAIN_USE_COLOR_AUGMENTATION:
                frames = _color_augmentation(frames, cfg, rng)
        else:
            px *= _scale_box_ratio(h0, w0, crop)
            frames = transform.short_side_scale(frames, crop)
            h, w = frames.shape[1:3]
            y0 = max(int(np.ceil((h - crop) / 2)), 0)  # `cv2_transform.py:188-189`
            x0 = max(int(np.ceil((w - crop) / 2)), 0)
            frames = frames[:, y0:y0 + crop, x0:x0 + crop]
            px -= np.array([x0, y0, x0, y0], np.float32)
            if cfg.AVA.TEST_FORCE_FLIP:
                frames = frames[:, :, ::-1]
                px = _flip_boxes(px, crop)
        px = _clip_boxes(px, crop, crop)

        n = min(len(px), MAX_BOXES)
        boxes_out = np.zeros((MAX_BOXES, 4), np.float32)
        boxes_out[:n] = px[:n]
        mask = np.zeros((MAX_BOXES,), bool)
        mask[:n] = True
        num_classes = cfg.MODEL.NUM_CLASSES
        label_out = np.zeros((MAX_BOXES, num_classes), np.float32)
        for i in range(n):
            for label in labels[i]:
                if 0 <= label < num_classes:
                    label_out[i, label] = 1.0
        ori_out = np.zeros((MAX_BOXES, 4), np.float32)
        ori_out[:n] = boxes[:n]
        out = np.empty(frames.shape, np.uint8)
        return {
            "frames": np.clip(frames, 0, 255, out=out, casting="unsafe"),
            "label": label_out,
            "boxes": boxes_out,
            "box_mask": mask,
            "ori_boxes": ori_out,
            "metadata": np.array([video_idx, sec], np.int64),
            "index": idx,
            "time": 0.0,
            "pm": False,
        }
