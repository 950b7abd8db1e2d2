"""The port's multi-view test loop and metrics against the JAX package's.

perform_test + TestMeter (numpy) against pmv_tpu's TestMeter fed the same
per-clip predictions; topks_correct (torch) against pmv_tpu's, ties
included.
"""

import numpy as np
import pytest
import torch

from pmv_tpu.utils import meters as jmeters
from pmv_tpu.utils import metrics as jmetrics
from pmv_tpu_torch.engine.steps import make_eval_step
from pmv_tpu_torch.engine.test import perform_test
from pmv_tpu_torch.entry import mvitv2_s_cfg
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.utils import meters, metrics


def _views(num_videos, num_clips, num_classes, batch, seed):
    """Clip batches in the test loader's order: clip i is a view of video
    i // num_clips; every view of a video has the video's label."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_videos)
    n = num_videos * num_clips
    index = np.arange(n)
    order = rng.permutation(n)  # views arrive in any order
    return [
        {"index": index[order[i:i + batch]],
         "labels": labels[index[order[i:i + batch]] // num_clips]}
        for i in range(0, n, batch)
    ]


@pytest.mark.parametrize("ensemble", ["sum", "max"])
def test_perform_test_matches_jax_test_meter(ensemble):
    cfg = mvitv2_s_cfg(tiny=True)
    num_videos, num_clips, batch = 3, 4, 5
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=1)
    eval_step = make_eval_step(cfg, model, device="cpu")
    rng = np.random.default_rng(2)
    loader = _views(num_videos, num_clips, cfg.MODEL.NUM_CLASSES, batch, 3)
    for b in loader:
        b["frames"] = rng.integers(0, 256, (len(b["index"]), 2, 16, 16, 3), np.uint8)

    preds_seen = []

    def recording_step(frames):
        preds = eval_step(frames)
        preds_seen.append(preds.numpy())
        return preds

    meter = meters.TestMeter(num_videos, num_clips, cfg.MODEL.NUM_CLASSES,
                             len(loader), ensemble_method=ensemble)
    meter, stats = perform_test(loader, recording_step, meter)

    ref = jmeters.TestMeter(num_videos, num_clips, cfg.MODEL.NUM_CLASSES,
                            len(loader), ensemble_method=ensemble)
    for b, preds in zip(loader, preds_seen):
        ref.update_stats(preds, b["labels"], b["index"])
    ref_stats = ref.finalize_metrics()

    np.testing.assert_allclose(meter.video_preds, ref.video_preds, rtol=0, atol=0)
    np.testing.assert_array_equal(meter.video_labels, ref.video_labels)
    np.testing.assert_array_equal(meter.clip_count, [num_clips] * num_videos)
    assert stats == ref_stats


def test_test_meter_rejects_inconsistent_labels():
    meter = meters.TestMeter(1, 2, 3, 1)
    meter.update_stats(np.ones((1, 3)), np.array([2]), np.array([0]))
    with pytest.raises(ValueError, match="inconsistent labels"):
        meter.update_stats(np.ones((1, 3)), np.array([1]), np.array([1]))


def test_multi_label_map_matches_jax():
    rng = np.random.default_rng(4)
    preds = rng.random((6, 4))
    labels = (rng.random((6, 4)) > 0.5).astype(np.float64)
    assert meters.get_map(preds, labels) == jmeters.get_map(preds, labels)


def test_topk_metrics_match_jax_with_ties():
    rng = np.random.default_rng(5)
    preds = rng.integers(0, 4, (64, 10)).astype(np.float32)  # many ties
    labels = rng.integers(0, 10, 64)
    ks = (1, 3, 5)
    got = [int(x) for x in metrics.topks_correct(torch.from_numpy(preds), torch.from_numpy(labels), ks)]
    ref = [int(x) for x in jmetrics.topks_correct(preds, labels, ks)]
    assert got == ref
    np.testing.assert_allclose(
        [float(x) for x in metrics.topk_errors(preds, labels, ks)],
        [float(x) for x in jmetrics.topk_errors(preds, labels, ks)], rtol=1e-6,
    )
    np.testing.assert_allclose(
        [float(x) for x in metrics.topk_accuracies(preds, labels, ks)],
        [float(x) for x in jmetrics.topk_accuracies(preds, labels, ks)], rtol=1e-6,
    )
