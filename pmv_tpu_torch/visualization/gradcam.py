"""Grad-CAM localization maps (`MViT/slowfast/visualization/gradcam_utils.py`).

Counterpart of `pmv_tpu/visualization/gradcam.py`. The JAX models hold a
zero-valued ``perturb`` tap named "features" before their heads, and JAX
takes the score's gradient with respect to it in a second forward. The
port's MViT, UniFormer and X3D hold an identity submodule, ``features``, at
the same point: MViT's tokens before the final norm, UniFormer's grid after
its last BatchNorm, X3D's last stage's grid. ``gradcam`` runs one forward
with a hook on it that hands the head a leaf tensor of the features, and
takes the score's gradient with respect to that leaf alone
(``torch.autograd.grad``): the gradient stops at the tap, and the forward
before it builds no graph. A model without the tap (the ResNet family, CSN,
R(2+1)D, AVSlowFast, the SSL models) raises ValueError; the JAX package
fails on them too (they have no "perturbations" collection).
"""

import contextlib

import numpy as np
import torch
from torch import nn


def feature_tap(model):
    """``model``'s Grad-CAM tap; ValueError where it has none."""
    tap = getattr(model, "features", None)
    if not isinstance(tap, nn.Identity):
        raise ValueError(
            f"{type(model).__name__} has no Grad-CAM tap: Grad-CAM takes MViT, UniFormer "
            "and X3D (the models of the JAX package with a 'features' perturb tap)"
        )
    return tap


@contextlib.contextmanager
def _frozen(model):
    """Parameters that need no gradient, for the length of the block."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def gradcam(model, frames, target_labels=None):
    """Grad-CAM of ``model`` (in eval mode) on the normalized ``frames``
    [B, ...]: the score of ``target_labels`` (by default each row's argmax)
    differentiated at the tap. Returns (maps [B, N] for token features or
    [B, T', H', W'] for grid features, each row min-max scaled into [0, 1];
    preds [B, NUM_CLASSES]), both float32 tensors on the model's device."""
    tap = feature_tap(model)
    model.eval()
    seen = {}

    def leaf(module, inputs, output):
        seen["features"] = output.detach().requires_grad_()
        return seen["features"]

    handle = tap.register_forward_hook(leaf)
    try:
        with _frozen(model), torch.enable_grad():
            preds = model(frames)
            labels = (preds.detach().argmax(dim=-1) if target_labels is None
                      else torch.as_tensor(target_labels, device=preds.device).long())
            score = preds.gather(1, labels[:, None]).sum()
            (grad,) = torch.autograd.grad(score, seen["features"])
    finally:
        handle.remove()
    feats = seen["features"].detach().float()
    grad = grad.float()
    if feats.dim() == 3:
        # Token features [B, N, C] (transformers): channel weights from the
        # gradient's mean over the tokens.
        weights = grad.mean(dim=1, keepdim=True)
    else:
        # Grid features [B, T, H, W, C] (convnets): the mean over T, H, W.
        weights = grad.mean(dim=(1, 2, 3), keepdim=True)
    cam = torch.relu((weights * feats).sum(dim=-1))
    flat = cam.reshape(cam.shape[0], -1)
    lo = flat.min(dim=1, keepdim=True).values
    hi = flat.max(dim=1, keepdim=True).values
    cam = ((flat - lo) / (hi - lo + 1e-8)).reshape(cam.shape)
    return cam, preds.detach().float()


def overlay_heatmap(frame, cam_2d, alpha=0.5):
    """Blend a [h, w] cam onto a [H, W, 3] uint8 frame (matplotlib's jet)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.cm as cm
    from PIL import Image

    h, w = frame.shape[:2]
    cam_img = Image.fromarray((np.asarray(cam_2d) * 255).astype(np.uint8))
    cam_img = cam_img.resize((w, h), Image.BILINEAR)
    heat = cm.jet(np.asarray(cam_img) / 255.0)[..., :3] * 255
    out = (1 - alpha) * frame.astype(np.float32) + alpha * heat
    return np.clip(out, 0, 255).astype(np.uint8)
