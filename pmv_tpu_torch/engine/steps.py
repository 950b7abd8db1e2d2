"""Eval step: uint8 clips -> normalized float -> model -> class scores.

Counterpart of the eval half of `pmv_tpu/engine/steps.py`. PyTorch runs
eagerly, so a step is a plain function over the model's own parameters; it
runs under ``torch.inference_mode()``.
"""

import torch

from pmv_tpu_torch.utils.device import resolve_device


def make_eval_preprocess_fn(cfg, device=None):
    """uint8 frames [B, T, H, W, 3] -> normalized float32, in the channel
    order of DATA.USE_BGR_ORDER (`kinetics.py:443-448` of the reference)."""
    mean = torch.tensor(cfg.DATA.MEAN, dtype=torch.float32) * 255.0
    inv_std = 1.0 / (torch.tensor(cfg.DATA.STD, dtype=torch.float32) * 255.0)
    mean, inv_std = mean.to(device), inv_std.to(device)
    use_bgr = cfg.DATA.USE_BGR_ORDER

    def preprocess(frames):
        x = frames.float()
        if use_bgr:
            x = x.flip(-1)
        return (x - mean) * inv_std

    return preprocess


def pack_pathways(cfg, x):
    """Single tensor -> per-pathway list. Single-pathway archs only here."""
    if cfg.MODEL.ARCH in cfg.MODEL.SINGLE_PATHWAY_ARCH:
        return [x]
    raise NotImplementedError(f"arch {cfg.MODEL.ARCH} is not ported yet")


def make_eval_step(cfg, model, device=None):
    """eval_step(frames) -> scores [B, NUM_CLASSES] (softmax'd head).

    ``frames`` is a uint8 [B, T, H, W, 3] array or tensor; it is moved to
    ``device`` (CUDA by default; raises without a CUDA device unless
    ``device="cpu"``), which must be the model's device."""
    device = resolve_device(device)
    preprocess = make_eval_preprocess_fn(cfg, device)
    model.eval()

    @torch.inference_mode()
    def eval_step(frames):
        frames = torch.as_tensor(frames).to(device, non_blocking=True)
        inputs = pack_pathways(cfg, preprocess(frames))
        return model(inputs[0])

    return eval_step
