"""Training and multi-view test meters (`MViT/slowfast/utils/meters.py`),
in numpy, with the JAX package's ``json_stats`` keys.

- ScalarMeter: windowed median smoothing.
- TrainMeter: eta, lr, loss, grad norm, top-1/5 errors and the iteration,
  data and net timers, logged every LOG_PERIOD iterations and per epoch.
- ValMeter: per-epoch top-1/5 errors and their minimum over epochs (mAP
  when multi-label).
- TestMeter: clip i belongs to video i // num_clips; per-video sum or max
  ensemble of the clips' softmax scores; labels must agree across a
  video's views; finalize reports top-1/top-5 accuracy (or mAP when
  multi-label).
- AVAMeter: AVA detection's train, val and test meter; the frame-level
  mAP of ``utils/ava_eval.py`` over the gathered detections.
- EpochTimer: epoch durations.
"""

import datetime
import os
from collections import deque

import numpy as np
import torch

from pmv_tpu_torch.utils import ava_eval
from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils import metrics
from pmv_tpu_torch.utils.timer import Timer

logger = pmv_logging.get_logger(__name__)


def gpu_mem_usage():
    """Peak device memory in GB (``torch.cuda.max_memory_allocated``), 0 on
    a machine without CUDA."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / 1024 ** 3


class ScalarMeter:
    """Median over a sliding window of scalar values (`meters.py` ScalarMeter)."""

    def __init__(self, window_size):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def reset(self):
        self.deque.clear()
        self.total = 0.0
        self.count = 0

    def add_value(self, value):
        self.deque.append(value)
        self.count += 1
        self.total += value

    def get_win_median(self):
        return np.median(self.deque)

    def get_win_avg(self):
        return np.mean(self.deque)

    def get_global_avg(self):
        return self.total / max(self.count, 1)


class TrainMeter:
    """Per-iteration and per-epoch training stats (`meters.py` TrainMeter)."""

    def __init__(self, epoch_iters, cfg):
        self._cfg = cfg
        self.epoch_iters = epoch_iters
        self.MAX_EPOCH = cfg.SOLVER.MAX_EPOCH * epoch_iters
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.loss = ScalarMeter(cfg.LOG_PERIOD)
        self.loss_total = 0.0
        self.lr = None
        self.grad_norm = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top1_err = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top5_err = ScalarMeter(cfg.LOG_PERIOD)
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.output_dir = cfg.OUTPUT_DIR
        self.multi_label = cfg.DATA.MULTI_LABEL

    def reset(self):
        self.loss.reset()
        self.loss_total = 0.0
        self.lr = None
        self.grad_norm.reset()
        self.mb_top1_err.reset()
        self.mb_top5_err.reset()
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0

    def iter_tic(self):
        self.iter_timer.reset()
        self.data_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()
        self.net_timer.pause()

    def data_toc(self):
        self.data_timer.pause()
        self.net_timer.reset()

    def update_stats(self, top1_err, top5_err, loss, lr, grad_norm, mb_size):
        self.loss.add_value(loss)
        self.lr = lr
        self.grad_norm.add_value(grad_norm)
        self.loss_total += loss * mb_size
        self.num_samples += mb_size
        if not self.multi_label:
            self.mb_top1_err.add_value(top1_err)
            self.mb_top5_err.add_value(top5_err)
            self.num_top1_mis += top1_err * mb_size
            self.num_top5_mis += top5_err * mb_size

    def log_iter_stats(self, cur_epoch, cur_iter):
        if (cur_iter + 1) % self._cfg.LOG_PERIOD != 0:
            return
        eta_sec = self.iter_timer.seconds() * (
            self.MAX_EPOCH - (cur_epoch * self.epoch_iters + cur_iter + 1)
        )
        stats = {
            "_type": "train_iter",
            "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "dt": self.iter_timer.seconds(),
            "dt_data": self.data_timer.seconds(),
            "dt_net": self.net_timer.seconds(),
            "eta": str(datetime.timedelta(seconds=int(eta_sec))),
            "loss": self.loss.get_win_median(),
            "lr": self.lr,
            "grad_norm": self.grad_norm.get_win_median(),
            "gpu_mem": f"{gpu_mem_usage():.2f}G",
        }
        if not self.multi_label:
            stats["top1_err"] = self.mb_top1_err.get_win_median()
            stats["top5_err"] = self.mb_top5_err.get_win_median()
        pmv_logging.log_json_stats(stats, logger)

    def log_epoch_stats(self, cur_epoch):
        eta_sec = self.iter_timer.seconds() * (
            self.MAX_EPOCH - (cur_epoch + 1) * self.epoch_iters
        )
        stats = {
            "_type": "train_epoch",
            "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
            "dt": self.iter_timer.seconds(),
            "dt_data": self.data_timer.seconds(),
            "dt_net": self.net_timer.seconds(),
            "eta": str(datetime.timedelta(seconds=int(eta_sec))),
            "lr": self.lr,
            "loss": self.loss_total / max(self.num_samples, 1),
            "gpu_mem": f"{gpu_mem_usage():.2f}G",
        }
        if not self.multi_label:
            stats["top1_err"] = self.num_top1_mis / max(self.num_samples, 1)
            stats["top5_err"] = self.num_top5_mis / max(self.num_samples, 1)
        pmv_logging.log_json_stats(stats, logger)


class ValMeter:
    """Validation stats of an epoch and the best over epochs (`meters.py`
    ValMeter)."""

    def __init__(self, max_iter, cfg):
        self._cfg = cfg
        self.max_iter = max_iter
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.mb_top1_err = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top5_err = ScalarMeter(cfg.LOG_PERIOD)
        self.min_top1_err = 100.0
        self.min_top5_err = 100.0
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.all_preds = []
        self.all_labels = []

    def reset(self):
        self.iter_timer.reset()
        self.mb_top1_err.reset()
        self.mb_top5_err.reset()
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.all_preds = []
        self.all_labels = []

    def iter_tic(self):
        self.iter_timer.reset()
        self.data_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()
        self.net_timer.pause()

    def data_toc(self):
        self.data_timer.pause()
        self.net_timer.reset()

    def update_stats(self, top1_err, top5_err, mb_size):
        self.mb_top1_err.add_value(top1_err)
        self.mb_top5_err.add_value(top5_err)
        self.num_top1_mis += top1_err * mb_size
        self.num_top5_mis += top5_err * mb_size
        self.num_samples += mb_size

    def update_predictions(self, preds, labels):
        self.all_preds.append(preds)
        self.all_labels.append(labels)

    def log_iter_stats(self, cur_epoch, cur_iter):
        if (cur_iter + 1) % self._cfg.LOG_PERIOD != 0:
            return
        eta_sec = self.iter_timer.seconds() * (self.max_iter - cur_iter - 1)
        stats = {
            "_type": "val_iter",
            "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.max_iter}",
            "time_diff": self.iter_timer.seconds(),
            "eta": str(datetime.timedelta(seconds=int(eta_sec))),
            "top1_err": self.mb_top1_err.get_win_median(),
            "top5_err": self.mb_top5_err.get_win_median(),
            "gpu_mem": f"{gpu_mem_usage():.2f}G",
        }
        pmv_logging.log_json_stats(stats, logger)

    def log_epoch_stats(self, cur_epoch):
        stats = {
            "_type": "val_epoch",
            "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
            "time_diff": self.iter_timer.seconds(),
            "gpu_mem": f"{gpu_mem_usage():.2f}G",
        }
        if self.all_labels and np.asarray(self.all_labels[0]).ndim > 1:
            stats["map"] = get_map(
                np.concatenate(self.all_preds, axis=0),
                np.concatenate(self.all_labels, axis=0),
            )
        else:
            top1_err = self.num_top1_mis / max(self.num_samples, 1)
            top5_err = self.num_top5_mis / max(self.num_samples, 1)
            self.min_top1_err = min(self.min_top1_err, top1_err)
            self.min_top5_err = min(self.min_top5_err, top5_err)
            stats["top1_err"] = top1_err
            stats["top5_err"] = top5_err
            stats["min_top1_err"] = self.min_top1_err
            stats["min_top5_err"] = self.min_top5_err
        pmv_logging.log_json_stats(stats, logger)
        return stats


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


class AVAMeter:
    """AVA's train, val and test meter (`pmv_tpu/utils/meters.py:429-586`,
    the reference's `meters.py:46-260`). Val and test gather (preds [K, C],
    ori_boxes [K, 4] in [0, 1], metadata [K, 2] of video index and second)
    over the valid boxes; ``finalize_metrics`` takes the AVA mAP under the
    label map's whitelist (every class without AVA.LABEL_MAP_FILE), the
    excluded timestamps and the groundtruth CSV: the full one in test (and
    in val with AVA.FULL_TEST_ON_VAL), else its keyframes at seconds
    divisible by 4. ``groundtruth`` given to it replaces the CSV's (the
    test's groundtruth from the batches, where no GROUNDTRUTH_FILE is
    shipped)."""

    def __init__(self, overall_iters, cfg, mode, video_idx_to_name=None):
        self.cfg = cfg
        self.lr = None
        self.loss = ScalarMeter(cfg.LOG_PERIOD)
        self.full_ava_test = cfg.AVA.FULL_TEST_ON_VAL
        self.mode = mode
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.all_preds = []
        self.all_ori_boxes = []
        self.all_metadata = []
        self.overall_iters = overall_iters
        self.full_map = 0.0
        self.max_map = 0.0
        ann = cfg.AVA.ANNOTATION_DIR
        exclusion = os.path.join(ann, cfg.AVA.EXCLUSION_FILE)
        self.excluded_keys = (ava_eval.read_exclusions(exclusion)
                              if ann and os.path.exists(exclusion) else set())
        labelmap = os.path.join(ann, cfg.AVA.LABEL_MAP_FILE)
        if ann and os.path.exists(labelmap):
            self.categories, self.class_whitelist = ava_eval.read_labelmap(labelmap)
        else:
            self.class_whitelist = set(range(1, cfg.MODEL.NUM_CLASSES + 1))
            self.categories = [{"id": i, "name": str(i)} for i in self.class_whitelist]
        gt_file = os.path.join(ann, cfg.AVA.GROUNDTRUTH_FILE)
        if ann and os.path.exists(gt_file):
            self.full_groundtruth = ava_eval.read_csv(gt_file, self.class_whitelist)
            self.mini_groundtruth = ava_eval.get_ava_mini_groundtruth(self.full_groundtruth)
        else:
            self.full_groundtruth = self.mini_groundtruth = None
        self.video_idx_to_name = video_idx_to_name

    def log_iter_stats(self, cur_epoch, cur_iter):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        eta_sec = self.iter_timer.seconds() * (self.overall_iters - cur_iter)
        stats = {
            "_type": f"{self.mode}_iter",
            "cur_iter": f"{cur_iter + 1}",
            "eta": str(datetime.timedelta(seconds=int(eta_sec))),
            "dt": self.iter_timer.seconds(),
            "dt_data": self.data_timer.seconds(),
            "dt_net": self.net_timer.seconds(),
            "mode": self.mode,
        }
        if self.mode in ("train", "val"):
            stats["cur_epoch"] = f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}"
        if self.mode == "train":
            stats["loss"] = self.loss.get_win_median()
            stats["lr"] = self.lr
        pmv_logging.log_json_stats(stats, logger)

    def iter_tic(self):
        self.iter_timer.reset()
        self.data_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()
        self.net_timer.pause()

    def data_toc(self):
        self.data_timer.pause()
        self.net_timer.reset()

    def reset(self):
        self.loss.reset()
        self.all_preds = []
        self.all_ori_boxes = []
        self.all_metadata = []

    def update_stats(self, preds, ori_boxes, metadata, loss=None, lr=None):
        if self.mode in ("val", "test"):
            self.all_preds.append(np.asarray(preds))
            self.all_ori_boxes.append(np.asarray(ori_boxes))
            self.all_metadata.append(np.asarray(metadata))
        if loss is not None:
            self.loss.add_value(loss)
        if lr is not None:
            self.lr = lr

    def finalize_metrics(self, log=True, groundtruth=None):
        """The mAP of the detections so far; ``groundtruth`` replaces the
        CSV's."""
        if groundtruth is None:
            full = self.mode == "test" or (self.full_ava_test and self.mode == "val")
            groundtruth = self.full_groundtruth if full else self.mini_groundtruth
        if groundtruth is None:
            raise ValueError("AVA groundtruth unavailable: set AVA.ANNOTATION_DIR and "
                             "AVA.GROUNDTRUTH_FILE, or pass groundtruth")
        self.full_map = ava_eval.evaluate_ava(
            np.concatenate(self.all_preds, axis=0),
            np.concatenate(self.all_ori_boxes, axis=0),
            np.concatenate(self.all_metadata, axis=0),
            self.excluded_keys, self.class_whitelist, self.categories,
            groundtruth=groundtruth, video_idx_to_name=self.video_idx_to_name,
        )
        self.max_map = max(self.max_map, self.full_map)
        if log:
            pmv_logging.log_json_stats({"mode": self.mode, "map": self.full_map}, logger)
        return self.full_map

    def log_epoch_stats(self, cur_epoch, groundtruth=None):
        """Val and test: the epoch's mAP, logged; returns its stats."""
        if self.mode not in ("val", "test"):
            return None
        self.finalize_metrics(log=False, groundtruth=groundtruth)
        stats = {
            "_type": f"{self.mode}_epoch",
            "cur_epoch": f"{cur_epoch + 1}",
            "mode": self.mode,
            "map": self.full_map,
            "gpu_mem": f"{gpu_mem_usage():.2f}G",
        }
        pmv_logging.log_json_stats(stats, logger)
        return stats


class EpochTimer:
    """Per-epoch durations (`train_net.py:671,729-741`)."""

    def __init__(self):
        self.timer = Timer()
        self.epoch_times = []

    def epoch_tic(self):
        self.timer.reset()

    def epoch_toc(self):
        self.timer.pause()
        self.epoch_times.append(self.timer.seconds())

    def last_epoch_time(self):
        return self.epoch_times[-1]

    def avg_epoch_time(self):
        return float(np.mean(self.epoch_times))

    def median_epoch_time(self):
        return float(np.median(self.epoch_times))
