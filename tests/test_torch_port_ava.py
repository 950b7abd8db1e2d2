"""The port's AVA data and evaluation against the JAX package's, on the CPU.

On a dump written from a seed by ``pmv_tpu_torch.tools.ava_dump`` (2 videos
of 90 JPEG frames of 64 x 48, keyframes at seconds 902-904, with the
groundtruth, the predicted-box lists, a label map and an excluded
timestamp):

- ``Ava``'s train samples (scale jitter, crop, flip, and the host colour
  augmentation on and off) and val samples (with AVA.TEST_FORCE_FLIP on
  and off), the JAX package's ``Ava.__getitem__`` drawing from the
  generator the port's sample is given (``numpy.random.default_rng``
  patched while it runs): frames equal, boxes within 1e-5, labels, box
  mask, original boxes and metadata equal;
- the AVA mAP of the port's ``AVAMeter`` and ``ava_eval`` against the JAX
  package's, to 1e-6, on random scores of every keyframe's boxes: in test
  and val mode with the groundtruth file, the label map and the
  exclusions, and without them, where the groundtruth comes from the
  batches (``engine.test.add_batch_groundtruth``, held to the JAX
  package's rule: class column c is action c + 1, boxes as [y1, x1, y2,
  x2]);
- the loader's collated batch: its keys, shapes and types, and which keys
  the prefetcher carries to the device.
"""

from collections import defaultdict

import numpy as np
import pytest
import torch

from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.data import ava as jax_ava
from pmv_tpu.utils import meters as jax_meters
from pmv_tpu_torch.data import ava
from pmv_tpu_torch.data.loader import construct_loader
from pmv_tpu_torch.engine.prefetch import DEVICE_KEYS
from pmv_tpu_torch.engine.test import add_batch_groundtruth
from pmv_tpu_torch.tools.ava_dump import write_ava_dump
from pmv_tpu_torch.utils import meters
from torch_port_util import port_cfg

NUM_CLASSES = 80


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    root = tmp_path_factory.mktemp("ava")
    write_ava_dump(str(root), videos=2, frames=90, width=64, height=48, seed=3)
    return root


def _cfg(root, *opts):
    cfg = jax_get_cfg()
    cfg.AVA.FRAME_DIR = str(root / "frames")
    cfg.AVA.FRAME_LIST_DIR = str(root / "frame_lists")
    cfg.AVA.ANNOTATION_DIR = str(root / "annotations")
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "ava"
    cfg.DETECTION.ENABLE = True
    cfg.MODEL.NUM_CLASSES = NUM_CLASSES
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.TRAIN_JITTER_SCALES = [36, 44]
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 2
    cfg.DATA_LOADER.NUM_WORKERS = 1
    cfg.NUM_GPUS = 1
    cfg.merge_from_list(list(opts))
    return cfg


def _assert_sample_equal(got, want):
    np.testing.assert_array_equal(got["frames"], want["frames"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-5, rtol=0)
    for key in ("label", "box_mask", "ori_boxes", "metadata"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["index"] == want["index"]


@pytest.mark.parametrize("mode,opts", [
    ("train", ()),
    ("train", ("AVA.TRAIN_USE_COLOR_AUGMENTATION", "True", "AVA.TRAIN_PCA_JITTER_ONLY", "False")),
    ("val", ()),
    ("val", ("AVA.TEST_FORCE_FLIP", "True")),
])
def test_samples_match_jax(dump, monkeypatch, mode, opts):
    cfg = _cfg(dump, *opts)
    mine, theirs = ava.Ava(port_cfg(cfg), mode), jax_ava.Ava(cfg, mode)
    assert len(mine) == len(theirs) == 6  # 2 videos x 3 keyframes
    assert mine._keyframe_indices == theirs._keyframe_indices
    real_rng = np.random.default_rng
    for idx in range(len(mine)):
        seed = (cfg.RNG_SEED, 0, idx)
        got = mine._sample(idx, real_rng(seed))
        with monkeypatch.context() as m:
            m.setattr(np.random, "default_rng", lambda *_: real_rng(seed))
            want = theirs[idx]
        _assert_sample_equal(got, want)
        assert got["frames"].shape == (4, 32, 32, 3) and got["frames"].dtype == np.uint8
        n = int(got["box_mask"].sum())
        assert 1 <= n <= 4 and got["label"][:n].sum() >= n and got["label"][n:].sum() == 0
    # The port's own draw: (RNG_SEED, epoch, index), the same at each call.
    _assert_sample_equal(mine[5], mine._sample(5, real_rng((cfg.RNG_SEED, 0, 5))))
    _assert_sample_equal(mine[5], mine[5])


def _random_detections(dataset, seed):
    """(preds [K, C], ori_boxes [K, 4], metadata [K, 2], labels [K, C]) of
    every keyframe's valid boxes, scores from ``seed``."""
    rng = np.random.default_rng(seed)
    rows = [dataset._sample(i, rng) for i in range(len(dataset))]
    masks = [r["box_mask"] for r in rows]
    ori = np.concatenate([r["ori_boxes"][m] for r, m in zip(rows, masks)])
    meta = np.concatenate([np.repeat(r["metadata"][None], m.sum(), 0) for r, m in zip(rows, masks)])
    labels = np.concatenate([r["label"][m] for r, m in zip(rows, masks)])
    preds = rng.uniform(size=labels.shape).astype(np.float32)
    preds = np.where(rng.uniform(size=labels.shape) < 0.3, np.roll(labels, 1, axis=1), preds)
    return preds, ori, meta, labels


def _jax_batch_groundtruth(labels, ori, metadata, names):
    """The groundtruth loop of the JAX package's ``test_detection``
    (`pmv_tpu/engine/test.py:138-152`)."""
    from pmv_tpu.utils.ava_eval import make_image_key

    boxes, ids, scores = defaultdict(list), defaultdict(list), defaultdict(list)
    for k in range(len(labels)):
        key = make_image_key(names[int(metadata[k][0])], int(metadata[k][1]))
        y1, x1, y2, x2 = ori[k][[1, 0, 3, 2]]
        for c in np.nonzero(labels[k])[0]:
            boxes[key].append([y1, x1, y2, x2])
            ids[key].append(int(c) + 1)
            scores[key].append(1.0)
    return boxes, ids, scores


@pytest.mark.parametrize("mode,files", [("test", True), ("val", True), ("test", False)])
def test_ava_map_matches_jax(dump, tmp_path, mode, files):
    cfg = _cfg(dump) if files else _cfg(dump, "AVA.ANNOTATION_DIR", str(tmp_path))
    names = ava.Ava(port_cfg(_cfg(dump)), "val")._video_names
    preds, ori, meta, labels = _random_detections(ava.Ava(port_cfg(_cfg(dump)), "val"), 5)
    mine = meters.AVAMeter(2, port_cfg(cfg), mode, video_idx_to_name=names)
    theirs = jax_meters.AVAMeter(2, cfg, mode, video_idx_to_name=names)
    assert (mine.full_groundtruth is None) == (not files)
    assert mine.excluded_keys == theirs.excluded_keys
    assert mine.class_whitelist == theirs.class_whitelist
    if files:
        assert mine.excluded_keys == {"video001,0903"} and len(mine.categories) == NUM_CLASSES
    half = len(preds) // 2
    for meter in (mine, theirs):
        for part in (slice(0, half), slice(half, None)):
            meter.update_stats(preds[part], ori[part], meta[part])
    gt = their_gt = None
    if not files:
        gt = (defaultdict(list), defaultdict(list), defaultdict(list))
        add_batch_groundtruth(gt, labels, ori, meta, names)
        their_gt = _jax_batch_groundtruth(labels, ori, meta, names)
        for got, want in zip(gt, their_gt):
            assert dict(got) == dict(want)
    got = mine.finalize_metrics(log=False, groundtruth=gt)
    want = theirs.finalize_metrics(log=False, groundtruth=their_gt)
    assert 0.0 < want < 1.0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if mode == "val":  # the mini groundtruth: seconds divisible by 4 (904)
        assert all(k.endswith(",0904") for k in mine.mini_groundtruth[0])
        stats = mine.log_epoch_stats(0)
        assert stats["_type"] == "val_epoch" and stats["map"] == got and mine.max_map == got


def test_collated_batch_and_device_keys(dump):
    cfg = port_cfg(_cfg(dump))
    loader = construct_loader(cfg, "train")
    batch = next(iter(loader))
    shapes = {k: (np.asarray(v).shape, np.asarray(v).dtype) for k, v in batch.items()}
    assert shapes == {
        "frames": ((2, 4, 32, 32, 3), np.uint8), "labels": ((2, 16, NUM_CLASSES), np.float32),
        "boxes": ((2, 16, 4), np.float32), "box_mask": ((2, 16), bool),
        "ori_boxes": ((2, 16, 4), np.float32), "metadata": ((2, 2), np.int64),
        "index": ((2,), np.int64), "time": ((2,), np.float32), "pm": ((2,), bool)}
    assert {"frames", "labels", "boxes", "box_mask"} <= set(DEVICE_KEYS)
    assert not {"ori_boxes", "metadata"} & set(DEVICE_KEYS)
    assert len(construct_loader(cfg, "test")) == 3
    assert torch.as_tensor(batch["box_mask"]).any(dim=1).all()
