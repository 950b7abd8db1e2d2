"""Model registry and builder (`MViT/slowfast/models/build.py`)."""

import torch

from pmv_tpu_torch.models.common import init_weights
from pmv_tpu_torch.utils.device import resolve_device
from pmv_tpu_torch.utils.registry import Registry

MODEL_REGISTRY = Registry("MODEL")


def compute_dtype(cfg):
    """Activation dtype: TRAIN.MIXED_PRECISION off -> float32, else
    TPU.COMPUTE_DTYPE (bfloat16 by default). Parameters stay float32."""
    if not cfg.TRAIN.MIXED_PRECISION:
        return torch.float32
    return {
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
        "float16": torch.float16,
    }[cfg.TPU.COMPUTE_DTYPE]


def build_model(cfg, device=None, dtype=None, seed=0):
    """The model named by cfg.MODEL.MODEL_NAME, initialised from ``seed``
    and placed on ``device`` (CUDA by default; raises without a CUDA device
    unless ``device="cpu"``). ``dtype`` is the activation dtype, by default
    ``compute_dtype(cfg)``; parameters are float32. The weights are drawn
    by the model's own ``init_weights(generator)`` where it has one (X3D's
    flax defaults), else by ``common.init_weights``."""
    device = resolve_device(device)
    if dtype is None:
        dtype = compute_dtype(cfg)
    model = MODEL_REGISTRY.get(cfg.MODEL.MODEL_NAME)(cfg, dtype=dtype)
    generator = torch.Generator().manual_seed(seed)
    if hasattr(model, "init_weights"):
        model.init_weights(generator)
    else:
        init_weights(model, generator)
    return model.to(device)
