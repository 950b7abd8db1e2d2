"""TensorBoard writer (`MViT/slowfast/visualization/tensorboard_vis.py:20-429`).

Counterpart of `pmv_tpu/visualization/tensorboard_vis.py`, which already
writes through ``torch.utils.tensorboard``; the same log directory, tags and
values. ``train()`` writes its evaluation's errors through it, on rank 0
only; VIS_MASK its comparison videos (``add_video``); the model and
wrong-prediction visualization (``tools/visualization.py``) its weight
histograms (``add_histogram``), input videos and, through ``plot_eval``, the
confusion matrix and the per-class top-k histograms, drawn by matplotlib,
which is imported only there: on a host without it ``plot_eval`` raises.
"""

import csv
import json
import os

import numpy as np
import torch

from pmv_tpu_torch.utils import logging as pmv_logging

logger = pmv_logging.get_logger(__name__)


class TensorboardWriter:
    def __init__(self, cfg):
        self.cfg = cfg
        if cfg.TENSORBOARD.LOG_DIR == "":
            log_dir = os.path.join(
                cfg.OUTPUT_DIR, "runs-{}".format(cfg.TRAIN.DATASET)
            )
        else:
            log_dir = os.path.join(cfg.OUTPUT_DIR, cfg.TENSORBOARD.LOG_DIR)
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=log_dir)
        logger.info("TensorBoard events at %s", log_dir)
        self.class_names = None
        if cfg.TENSORBOARD.CLASS_NAMES_PATH:
            self.class_names = get_class_names(cfg.TENSORBOARD.CLASS_NAMES_PATH)

    def add_scalars(self, data_dict, global_step=None):
        for key, item in data_dict.items():
            self.writer.add_scalar(key, item, global_step)

    def add_video(self, video, tag="Video Input", global_step=None, fps=4):
        """``video``: [B, T, H, W, C], uint8 or clipped to it
        (``torch.utils.tensorboard`` encodes it with moviepy, and skips it
        where moviepy is absent)."""
        video = np.asarray(video)
        if video.dtype != np.uint8:
            video = np.clip(video, 0, 255).astype(np.uint8)
        frames = torch.from_numpy(np.ascontiguousarray(video)).permute(0, 1, 4, 2, 3)
        self.writer.add_video(tag, frames, global_step=global_step, fps=fps)

    def add_histogram(self, tag, values, global_step=None):
        """A histogram of ``values`` flattened (the weights'
        ``plot_weights_and_activations``)."""
        if torch.is_tensor(values):
            values = values.detach().float().cpu().numpy()
        self.writer.add_histogram(tag, np.asarray(values).ravel(), global_step=global_step)

    def plot_eval(self, preds, labels, global_step=None):
        """With TENSORBOARD.CONFUSION_MATRIX.ENABLE, the confusion matrix of
        ``preds`` [N, C] against ``labels`` [N], and with HISTOGRAM.ENABLE
        the top-k histogram of each of the first 50 classes."""
        if not self.cfg.TENSORBOARD.CONFUSION_MATRIX.ENABLE:
            return
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        num_classes = self.cfg.MODEL.NUM_CLASSES
        cmtx = confusion_matrix(preds.argmax(axis=-1), labels, num_classes)
        fig = plot_confusion_matrix(
            cmtx, num_classes, self.class_names,
            figsize=self.cfg.TENSORBOARD.CONFUSION_MATRIX.FIGSIZE,
        )
        self.writer.add_figure("Confusion Matrix", fig, global_step=global_step)
        if self.cfg.TENSORBOARD.HISTOGRAM.ENABLE:
            topk = self.cfg.TENSORBOARD.HISTOGRAM.TOPK
            for c in range(min(num_classes, 50)):
                fig = plot_topk_histogram(
                    c, cmtx, topk, self.class_names,
                    figsize=self.cfg.TENSORBOARD.HISTOGRAM.FIGSIZE,
                )
                self.writer.add_figure(f"Histogram/class_{c}", fig, global_step=global_step)

    def close(self):
        self.writer.flush()
        self.writer.close()


def get_class_names(path):
    """Class id -> name from the PMV class_name_mapping.csv format
    (`data/class_name_mapping.csv`: ``<name>,<id>`` rows) or a JSON map."""
    if path.endswith(".json"):
        with open(path) as f:
            mapping = json.load(f)
        return [mapping[str(i)] for i in range(len(mapping))]
    names = {}
    with open(path) as f:
        for row in csv.reader(f):
            if len(row) >= 2:
                names[int(row[1])] = row[0]
    return [names.get(i, str(i)) for i in range(max(names) + 1)] if names else []


def confusion_matrix(pred_ids, labels, num_classes):
    """[true, predicted] counts."""
    cmtx = np.zeros((num_classes, num_classes), np.int64)
    for p, t in zip(pred_ids, labels):
        cmtx[int(t), int(p)] += 1
    return cmtx


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_confusion_matrix(cmtx, num_classes, class_names=None, figsize=None):
    plt = _pyplot()
    if not class_names:
        class_names = [str(i) for i in range(num_classes)]
    fig = plt.figure(figsize=figsize or (8, 8))
    plt.imshow(cmtx, interpolation="nearest", cmap=plt.cm.Blues)
    plt.title("Confusion matrix")
    plt.colorbar()
    plt.ylabel("True label")
    plt.xlabel("Predicted label")
    plt.tight_layout()
    return fig


def plot_topk_histogram(class_id, cmtx, k, class_names=None, figsize=None):
    plt = _pyplot()
    row = cmtx[class_id]
    top = np.argsort(row)[::-1][:k]
    if not class_names:
        class_names = [str(i) for i in range(len(row))]
    fig = plt.figure(figsize=figsize or (8, 8))
    plt.bar(range(len(top)), row[top])
    plt.xticks(range(len(top)), [class_names[i] for i in top], rotation=45, ha="right")
    plt.title(f"Top-{k} predictions for true class {class_names[class_id]}")
    plt.tight_layout()
    return fig
