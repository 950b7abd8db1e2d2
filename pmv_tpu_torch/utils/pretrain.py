"""UniFormer pretrain registry (`Uniformer/slowfast/models/uniformer.py:16-29`
and ``get_pretrained_model`` at `:440-463`, loaded by the fork's
`build.py:42-46`).

The port's copy of `pmv_tpu/utils/pretrain.py:20-73`. A name maps to
``<root>/<name>.pth``, the root being $PMV_PRETRAIN_ROOT where it is set,
else the reference's bytenas mount ``/mnt/bn/$BYTENAS_VOLUME_NAME/
pretrained_model``; a path that exists is taken as it is. The file loads
through ``utils/torch_import.py``: its 2-D image kernels inflated over T, a
head of another class count dropped, the parameters alone (the reference's
``inflate_weight`` and its ``head.weight`` deletion). ``train()`` loads it
at start epoch 0 with no TRAIN.CHECKPOINT_FILE_PATH for Uniformer and
Uniformerframe, as the JAX package's does (`pmv_tpu/engine/train.py:
246-258`).
"""

import os

from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils import torch_import

logger = pmv_logging.get_logger(__name__)

_NAMES = [
    "uniformer_small_in1k",
    "uniformer_small_k400_8x8",
    "uniformer_small_k400_16x4",
    "uniformer_small_pm_k400_16x4",
    "uniformer_small_k600_16x4",
    "uniformer_base_in1k",
    "uniformer_base_k400_8x8",
    "uniformer_base_k400_16x4",
    "uniformer_base_k600_16x4",
    "uniformer_base_k600_32x4",
]

MODELS = ("Uniformer", "Uniformerframe")  # the models that load a pretrain


def pretrain_root():
    root = os.environ.get("PMV_PRETRAIN_ROOT", "")
    if root:
        return root
    vol = os.environ.get("BYTENAS_VOLUME_NAME", "")
    if vol:
        return f"/mnt/bn/{vol}/pretrained_model"
    return ""


def model_paths():
    root = pretrain_root()
    return {name: os.path.join(root, f"{name}.pth") for name in _NAMES}


def resolve(name):
    """Registry name or direct path -> checkpoint path; KeyError listing the
    names otherwise."""
    if os.path.exists(name):
        return name
    paths = model_paths()
    if name in paths:
        return paths[name]
    raise KeyError(
        f"unknown pretrain '{name}' (registry: {sorted(paths)}; "
        f"set $PMV_PRETRAIN_ROOT or pass a path)"
    )


def load_pretrained(cfg, model):
    """Load cfg.UNIFORMER.PRETRAIN_NAME into ``model``'s parameters. Returns
    the path loaded, or None where the name is empty."""
    name = cfg.UNIFORMER.PRETRAIN_NAME
    if not name:
        return None
    path = resolve(name)
    logger.info("Loading UniFormer pretrain '%s' from %s", name, path)
    torch_import.load_params(model, torch_import.read_state_dict(path))
    return path
