"""Reference PyTorch checkpoints into the port's models
(`MViT/slowfast/utils/checkpoint.py:152-188, 191-563`, `uniformer.py:429-440`).

Counterpart of `pmv_tpu/utils/torch_import.py:83-228`, whose flax layouts
and name map the port does not need: its modules carry the reference's names
and layouts. What stays is the import's rule:

- the state dict is the checkpoint's "model_state", "model" or
  "state_dict" entry, else the checkpoint itself;
- the model's parameters load by name, and only they: BatchNorm running
  statistics keep their init, as the JAX package fills its "params" tree
  alone (`:220-227`). Names only one side has are logged (non-strict);
- a 4-D conv weight [O, I, H, W] where the model's is 5-D [O, I, T, H, W]
  is inflated: repeated over the kernel's T and divided by T (average
  inflation, the reference's ``inflate_weight``), whatever
  TRAIN.CHECKPOINT_INFLATE says, as JAX inflates whenever the ranks differ
  (`:102-107`);
- a "head" or "projection" tensor of another shape (another class count)
  keeps the model's init (`:158-167`); another shape elsewhere raises
  ValueError.

``utils/checkpoint.py`` routes a file here where it needs inflation, where
TRAIN.CHECKPOINT_INFLATE is set, or where it holds no "model_state" (a
reference ``.pth``); ``utils/pretrain.py`` routes every UniFormer pretrain
here. The port's own ``.pyth`` checkpoints load there, statistics and
optimizer included.
"""

import torch

from pmv_tpu_torch.parallel import distributed
from pmv_tpu_torch.utils import logging as pmv_logging

logger = pmv_logging.get_logger(__name__)


def state_dict_of(checkpoint):
    """The state dict a loaded checkpoint holds (`torch_import.py:127-131`)."""
    for key in ("model_state", "model", "state_dict"):
        if isinstance(checkpoint, dict) and key in checkpoint:
            return checkpoint[key]
    return checkpoint


def read_state_dict(path):
    return state_dict_of(torch.load(path, map_location="cpu", weights_only=True))


def needs_inflation(state_dict, model):
    """Whether a weight of ``state_dict`` is 4-D where ``model``'s is 5-D."""
    params = dict(model.named_parameters())
    return any(name in params and value.dim() == 4 and params[name].dim() == 5
               for name, value in state_dict.items())


def convert(name, value, like):
    """``value`` in the shape of the model's parameter ``like``: as it is, or
    a 2-D kernel inflated over T; ValueError otherwise."""
    if tuple(value.shape) == tuple(like.shape):
        return value.to(like.dtype)
    if value.dim() == 4 and like.dim() == 5 and (
            tuple(value.shape) == tuple(like.shape[:2]) + tuple(like.shape[3:])):
        t = like.shape[2]
        return (value.unsqueeze(2).repeat(1, 1, t, 1, 1) / float(t)).to(like.dtype)
    raise ValueError(f"cannot convert {name}: checkpoint {tuple(value.shape)} -> model "
                     f"{tuple(like.shape)}")


def load_params(model, state_dict):
    """Load ``state_dict``'s tensors into ``model``'s parameters by name (the
    module docstring's rule), into its shards under FSDP. Returns the
    parameter names that kept their init."""
    params = dict(model.named_parameters())
    merged = model.state_dict()
    kept = []
    for name, like in params.items():
        if name not in state_dict:
            kept.append(name)
            continue
        try:
            value = convert(name, state_dict[name], like)
        except ValueError:
            if "head" not in name and "projection" not in name:
                raise
            logger.info("Dropping %s (shape mismatch: checkpoint %s, model %s)", name,
                        tuple(state_dict[name].shape), tuple(like.shape))
            kept.append(name)
            continue
        merged[name] = distributed.shard_like(value, merged[name])
    unused = [k for k in state_dict if k not in params]
    if kept:
        logger.warning("Kept their init: %s", kept[:10])
    if unused:
        logger.info("Unused checkpoint tensors (statistics included): %s", unused[:10])
    logger.info("Imported %d of the model's %d parameters; %d kept their init",
                len(params) - len(kept), len(params), len(kept))
    model.load_state_dict(merged, strict=True)
    return kept
