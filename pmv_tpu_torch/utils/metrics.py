"""Accuracy / error metrics on tensors (`MViT/slowfast/utils/metrics.py`)."""

import torch


def topks_correct(preds, labels, ks):
    """Number of top-k correct predictions for each k.

    preds [N, C] scores, labels [N] ints (tensors or arrays). Ties rank the
    higher class index first, as the JAX package's descending argsort does.
    """
    preds, labels = torch.as_tensor(preds), torch.as_tensor(labels)
    if preds.shape[0] != labels.shape[0]:
        raise ValueError(f"{preds.shape[0]} predictions, {labels.shape[0]} labels")
    max_k = int(max(ks))
    top_inds = torch.argsort(preds, dim=1, stable=True).flip(1)[:, :max_k]
    correct = top_inds == labels.reshape(-1, 1)
    return [correct[:, :k].any(dim=1).sum() for k in ks]


def topk_errors(preds, labels, ks):
    """Top-k error percentage for each k."""
    n = len(preds)
    return [(1.0 - x / n) * 100.0 for x in topks_correct(preds, labels, ks)]


def topk_accuracies(preds, labels, ks):
    """Top-k accuracy percentage for each k."""
    n = len(preds)
    return [(x / n) * 100.0 for x in topks_correct(preds, labels, ks)]
