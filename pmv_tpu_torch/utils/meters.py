"""Multi-view test meter (`MViT/slowfast/utils/meters.py:247-436`), in numpy.

TestMeter: clip i belongs to video i // num_clips; per-video sum or max
ensemble of the clips' softmax scores; labels must agree across a video's
views; finalize reports top-1/top-5 accuracy (or mAP when multi-label).
"""

import datetime

import numpy as np

from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils import metrics
from pmv_tpu_torch.utils.timer import Timer

logger = pmv_logging.get_logger(__name__)


class TestMeter:
    """Multi-view ensemble over num_clips = ensemble views x spatial crops."""

    def __init__(
        self,
        num_videos,
        num_clips,
        num_cls,
        overall_iters,
        multi_label=False,
        ensemble_method="sum",
    ):
        if ensemble_method not in ("sum", "max"):
            raise ValueError(f"ensemble_method {ensemble_method!r}")
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.num_clips = num_clips
        self.overall_iters = overall_iters
        self.multi_label = multi_label
        self.ensemble_method = ensemble_method
        self.video_preds = np.zeros((num_videos, num_cls), dtype=np.float64)
        if multi_label:
            self.video_preds -= 1e10
        self.video_labels = np.zeros(
            (num_videos, num_cls) if multi_label else (num_videos,),
            dtype=np.float64 if multi_label else np.int64,
        )
        self.clip_count = np.zeros((num_videos,), dtype=np.int64)
        self.stats = {}

    def reset(self):
        self.clip_count[:] = 0
        self.video_preds[:] = 0.0
        if self.multi_label:
            self.video_preds -= 1e10
        self.video_labels[:] = 0

    def update_stats(self, preds, labels, clip_ids):
        """Accumulate per-clip scores into per-video ensembles."""
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        clip_ids = np.asarray(clip_ids)
        for ind in range(preds.shape[0]):
            vid_id = int(clip_ids[ind]) // self.num_clips
            if self.video_labels[vid_id].sum() > 0 and not np.array_equal(
                self.video_labels[vid_id], labels[ind]
            ):
                raise ValueError(
                    f"inconsistent labels for video {vid_id} across views"
                )
            self.video_labels[vid_id] = labels[ind]
            if self.ensemble_method == "sum":
                self.video_preds[vid_id] += preds[ind]
            else:
                self.video_preds[vid_id] = np.maximum(
                    self.video_preds[vid_id], preds[ind]
                )
            self.clip_count[vid_id] += 1

    def iter_tic(self):
        self.iter_timer.reset()
        self.data_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()
        self.net_timer.pause()

    def data_toc(self):
        self.data_timer.pause()
        self.net_timer.reset()

    def log_iter_stats(self, cur_iter):
        eta_sec = self.iter_timer.seconds() * (self.overall_iters - cur_iter)
        stats = {
            "split": "test_iter",
            "cur_iter": f"{cur_iter + 1}",
            "eta": str(datetime.timedelta(seconds=int(eta_sec))),
            "time_diff": self.iter_timer.seconds(),
        }
        pmv_logging.log_json_stats(stats, logger)

    def finalize_metrics(self, ks=(1, 5)):
        if not all(self.clip_count == self.num_clips):
            bad = np.argwhere(self.clip_count != self.num_clips).flatten()
            logger.warning(
                "clip count %s ~= num clips %s",
                ", ".join(f"{i}: {self.clip_count[i]}" for i in bad[:20]),
                self.num_clips,
            )
        self.stats = {"split": "test_final"}
        if self.multi_label:
            self.stats["map"] = get_map(self.video_preds, self.video_labels)
        else:
            num_topks_correct = metrics.topks_correct(
                self.video_preds, self.video_labels, ks
            )
            for k, n in zip(ks, num_topks_correct):
                topk = float(n) / self.video_preds.shape[0] * 100.0
                self.stats[f"top{k}_acc"] = f"{topk:.2f}"
        pmv_logging.log_json_stats(self.stats, logger)
        return self.stats


def get_map(preds, labels):
    """Mean average precision over classes (multi-label eval)."""
    logger.info("Getting mAP for %d examples", preds.shape[0])
    keep = ~(labels.sum(axis=1) == 0)
    preds, labels = preds[keep], labels[keep]
    aps = []
    for c in range(preds.shape[1]):
        if labels[:, c].sum() == 0:
            continue
        aps.append(_average_precision(preds[:, c], labels[:, c]))
    return float(np.mean(aps)) if aps else 0.0


def _average_precision(scores, targets):
    order = np.argsort(-scores)
    targets = targets[order]
    tp = np.cumsum(targets)
    precision = tp / (np.arange(len(targets)) + 1)
    return float((precision * targets).sum() / max(targets.sum(), 1))
