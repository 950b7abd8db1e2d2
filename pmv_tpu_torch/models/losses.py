"""Loss functions (`MViT/slowfast/models/losses.py:65-87`).

Counterpart of `pmv_tpu/models/losses.py`: every entry of ``get_loss_func``,
with the same ``reduction`` ("mean" or anything else for per-element).
"""

import torch
import torch.nn.functional as F


def _reduce(losses, reduction):
    return losses.mean() if reduction == "mean" else losses


def cross_entropy(logits, labels, reduction="mean"):
    """labels: int class ids."""
    return _reduce(F.cross_entropy(logits, labels.long(), reduction="none"), reduction)


def soft_cross_entropy(logits, soft_targets, reduction="mean", normalize_targets=False):
    """Soft-target CE (pytorchvideo SoftTargetCrossEntropyLoss used by mixup)."""
    if normalize_targets:
        soft_targets = soft_targets / soft_targets.sum(dim=-1, keepdim=True).clamp_min(1e-8)
    losses = -(soft_targets * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    return _reduce(losses, reduction)


def bce(preds, labels, reduction="mean"):
    losses = -(
        labels * torch.log(preds.clamp(1e-8, 1.0))
        + (1 - labels) * torch.log((1 - preds).clamp(1e-8, 1.0))
    )
    return _reduce(losses, reduction)


def bce_logit(logits, labels, reduction="mean"):
    """optax.sigmoid_binary_cross_entropy: -y log s(x) - (1 - y) log s(-x)."""
    losses = -labels * F.logsigmoid(logits) - (1 - labels) * F.logsigmoid(-logits)
    return _reduce(losses, reduction)


def mse(preds, targets, reduction="mean"):
    return _reduce((preds - targets) ** 2, reduction)


_LOSSES = {
    "cross_entropy": cross_entropy,
    "soft_cross_entropy": soft_cross_entropy,
    "bce": bce,
    "bce_logit": bce_logit,
    "mse": mse,
}


def get_loss_func(loss_name):
    if loss_name not in _LOSSES:
        raise NotImplementedError(f"Loss {loss_name} is not supported")
    return _LOSSES[loss_name]
