"""Checkpoints in the reference's ``.pyth`` layout
(`MViT/slowfast/utils/checkpoint.py`; counterpart of
`pmv_tpu/utils/checkpoint.py`, which writes orbax directories).

- ``torch.save`` of {"epoch", "model_state" (the weights and the buffers:
  BatchNorm running statistics), "optimizer_state", "cfg"} to
  ``OUTPUT_DIR/checkpoints/checkpoint_epoch_{epoch:05d}.pyth`` (prefixed
  with TASK when set), written by rank 0 only, through a temporary file and
  a rename, so that a cut job never leaves half a checkpoint. Every rank of
  a multi-process job calls ``save_checkpoint``: under FSDP the sharded
  weights and optimizer state are gathered whole first (a collective), so
  that the file is the one a single process or DDP writes; the ranks wait
  for rank 0's write to end. Every rank loads the whole file, and under
  FSDP keeps its shards of it: a checkpoint written under one strategy
  resumes under another.
- ``get_last_checkpoint``: the lexicographic maximum of the names.
- ``load_train_checkpoint``: TRAIN.AUTO_RESUME resumes from the last
  checkpoint at its epoch + 1 with the weights and the optimizer's state
  (AdamW's moments and step count) exactly; else TRAIN.CHECKPOINT_FILE_PATH
  loads with TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN and
  TRAIN.CHECKPOINT_EPOCH_RESET.
- ``load_test_checkpoint``: TEST.CHECKPOINT_FILE_PATH, else the last
  checkpoint, else TRAIN.CHECKPOINT_FILE_PATH, else the random init.

Loading matches names: a reference PySlowFast ``.pyth`` of the same model
loads directly. A weight whose shape differs from the model's raises, as in
the JAX package (its torch importer, and its forward on a restored tree of
other shapes), except the head's, which keeps the model's value (a
checkpoint of another class count); names only one side has are logged.
So a model built for another crop (a test geometry other than the train
one: other rel-pos table sizes) refuses the checkpoint. A load with
TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN is one across models (MaskFeat's
pre-training into the supervised MViT, whose last blocks pool otherwise):
there a weight of another shape keeps the model's value, as in the JAX
package, and the optimizer's state is not loaded. CHECKPOINT_TYPE "caffe2"
(TRAIN and TEST) reads a Caffe2 zoo pickle through ``utils/c2_import.py``:
the model's parameters only (BatchNorm statistics keep their init, a head
of another shape too), no optimizer state, training from epoch 0, as the
JAX package loads it (`pmv_tpu/utils/checkpoint.py:196-201,237-241`). A
file that needs 2D->3D inflation (a 4-D weight where the model's is 5-D),
that holds no "model_state" (a reference ``.pth``: "model" or "state_dict",
or the bare state dict), or any file under TRAIN.CHECKPOINT_INFLATE loads
through ``utils/torch_import.py``: the parameters alone, inflated where
their ranks differ, a head of another shape kept at its init, no optimizer
state, epoch 0, as the JAX package imports every PyTorch file
(`pmv_tpu/utils/checkpoint.py:186-195`). The JAX package's orbax
directories are not read: NotImplementedError.
"""

import os
import re
import time

import torch

from pmv_tpu_torch.parallel import distributed
from pmv_tpu_torch.utils import c2_import, torch_import
from pmv_tpu_torch.utils import logging as pmv_logging

logger = pmv_logging.get_logger(__name__)

_CHECKPOINT_DIR = "checkpoints"
_NAME_RE = re.compile(r"checkpoint_epoch_(\d+)\.pyth$")


def get_checkpoint_dir(path_to_job):
    return os.path.join(path_to_job, _CHECKPOINT_DIR)


def get_path_to_checkpoint(path_to_job, epoch, task=""):
    name = f"checkpoint_epoch_{epoch:05d}.pyth"
    if task:
        name = f"{task}_{name}"
    return os.path.join(get_checkpoint_dir(path_to_job), name)


def get_last_checkpoint(path_to_job, task=""):
    d = get_checkpoint_dir(path_to_job)
    if not os.path.isdir(d):
        return None
    names = [
        f for f in os.listdir(d)
        if _NAME_RE.search(f) and (not task or f.startswith(task))
    ]
    if not names:
        return None
    return os.path.join(d, sorted(names)[-1])


def has_checkpoint(path_to_job, task=""):
    return get_last_checkpoint(path_to_job, task) is not None


def is_checkpoint_epoch(cfg, cur_epoch):
    return (
        (cur_epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0
        or cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH
    )


def full_state(state):
    """(model state_dict, optimizer state_dict) of ``state`` with every
    sharded tensor gathered whole (every rank calls it)."""
    model_state = {k: distributed.full(v) for k, v in state.model.state_dict().items()}
    opt_state = state.optimizer.state_dict()
    opt_state["state"] = {
        i: {k: distributed.full(v) for k, v in s.items()}
        for i, s in opt_state["state"].items()
    }
    return model_state, opt_state


def save_checkpoint(path_to_job, state, epoch, cfg):
    """Write ``state`` after epoch ``epoch`` (0-based) as checkpoint
    ``epoch + 1``; returns its path (None on ranks other than 0). Every rank
    of a multi-process job calls it, and it returns on each once the file
    is written."""
    model_state, opt_state = full_state(state)
    path = None
    if pmv_logging.is_master_process():
        os.makedirs(get_checkpoint_dir(path_to_job), exist_ok=True)
        path = get_path_to_checkpoint(path_to_job, epoch + 1, cfg.TASK)
        payload = {
            "epoch": epoch,
            "model_state": model_state,
            "optimizer_state": opt_state,
            "cfg": cfg.dump(),
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        tic = time.perf_counter()
        torch.save(payload, tmp)
        os.replace(tmp, path)
        logger.info("Saved checkpoint to %s in %.4fs", path, time.perf_counter() - tic)
    distributed.barrier()
    return path


def _read(path):
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory: the JAX package's orbax checkpoints are not "
            "read by the port"
        )
    return torch.load(path, map_location="cpu", weights_only=True)


def _rename(state_dict, patterns, log=True):
    """TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN: drop the first occurrence of
    each pattern from the names that hold it (`checkpoint.py:312-328`)."""
    for item in patterns:
        renamed = {}
        for k, v in state_dict.items():
            if item in k:
                k_new = k.replace(item, "", 1)
                if log:
                    logger.info("renaming: %s -> %s", k, k_new)
                k = k_new
            renamed[k] = v
        state_dict = renamed
    return state_dict


def load_model_state(model, state_dict, clear_name_pattern=()):
    """Load the weights of ``state_dict`` that ``model`` has, by name.
    Returns the names that kept the model's value. With
    ``clear_name_pattern`` (a load across models, such as a MaskFeat
    pre-training's backbone into the supervised MViT) a weight of another
    shape keeps the model's value too, as in the JAX package's
    ``clear_name_patterns`` (`pmv_tpu/utils/checkpoint.py:120-165`)."""
    loaded = _rename(dict(state_dict), clear_name_pattern)
    merged = model.state_dict()
    missing = []
    for name, value in merged.items():
        if name not in loaded:
            missing.append(name)
            continue
        src = loaded[name]
        if tuple(src.shape) != tuple(value.shape):
            if "head" in name or "projection" in name or clear_name_pattern:
                logger.info("Dropping %s (shape mismatch: checkpoint %s, model %s)",
                            name, tuple(src.shape), tuple(value.shape))
                missing.append(name)
                continue
            raise ValueError(
                f"checkpoint weight {name} has shape {tuple(src.shape)}, the "
                f"model's is {tuple(value.shape)}"
            )
        merged[name] = distributed.shard_like(src, value)
    unused = [k for k in loaded if k not in merged]
    if missing:
        logger.warning("Missing from the checkpoint: %s", missing[:10])
    if unused:
        logger.info("Unused checkpoint weights: %s", unused[:10])
    logger.info("Loaded %d of the model's %d tensors from the checkpoint; %d kept their init",
                len(merged) - len(missing), len(merged), len(missing))
    model.load_state_dict(merged, strict=True)
    return missing


def load_checkpoint(path, state=None, model=None, epoch_reset=False,
                    clear_name_pattern=(), checkpoint_type="pytorch",
                    inflate=False, before_load=None):
    """Load checkpoint ``path`` into ``state`` (model and optimizer) or into
    ``model`` alone. The optimizer's state comes back when the checkpoint
    holds one of this package's (its groups carry "count") and neither
    ``epoch_reset`` nor a name pattern is given. Returns the checkpoint's
    epoch, or -1 under ``epoch_reset``; ``before_load(epoch)``, when given,
    is called with it once the file is read, before anything loads. A
    caffe2 checkpoint loads the model's parameters alone and counts as
    epoch -1 (``c2_import``), and so does a file that goes through
    ``torch_import`` (the module docstring's rule; with ``inflate``,
    TRAIN.CHECKPOINT_INFLATE, every file)."""
    model = state.model if state is not None else model
    if checkpoint_type == "caffe2":
        params = c2_import.model_params(path, model)
        if before_load is not None:
            before_load(-1)
        load_model_state(model, params)
        return -1
    ckpt = _read(path)
    imported = torch_import.state_dict_of(ckpt)
    if inflate or "model_state" not in ckpt or torch_import.needs_inflation(
            _rename(imported, clear_name_pattern, log=False), model):
        if before_load is not None:
            before_load(-1)
        torch_import.load_params(model, _rename(imported, clear_name_pattern))
        return -1
    epoch = -1 if epoch_reset or "epoch" not in ckpt else int(ckpt["epoch"])
    if before_load is not None:
        before_load(epoch)
    load_model_state(model, ckpt["model_state"], clear_name_pattern)
    opt_state = ckpt.get("optimizer_state")
    if (
        state is not None and opt_state is not None and not epoch_reset
        and not clear_name_pattern
        and all("count" in g for g in opt_state.get("param_groups", ()))
    ):
        state.optimizer.load_state_dict(_sharded_like(opt_state, state.optimizer))
        state.step = int(state.optimizer.param_groups[0]["count"])
    return epoch


def _sharded_like(opt_state, optimizer):
    """``opt_state`` (whole tensors) with each parameter's state laid out as
    the parameter is (its shard under FSDP)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    out = dict(opt_state)
    out["state"] = {
        i: {k: distributed.shard_like(v, params[int(i)]) if torch.is_tensor(v)
            and v.shape == params[int(i)].shape else v for k, v in s.items()}
        for i, s in opt_state["state"].items()
    }
    return out


def load_train_checkpoint(cfg, state, before_load=None):
    """Auto-resume, or the given checkpoint (`train_net.py:589-631`).
    Returns the epoch to start from; ``before_load`` as ``load_checkpoint``
    takes it (``engine/train.py`` sets the multigrid long cycle of the
    checkpoint's epoch)."""
    if cfg.TRAIN.AUTO_RESUME and has_checkpoint(cfg.OUTPUT_DIR, cfg.TASK):
        last = get_last_checkpoint(cfg.OUTPUT_DIR, cfg.TASK)
        logger.info("Load from last checkpoint, %s.", last)
        return load_checkpoint(last, state, before_load=before_load) + 1
    if cfg.TRAIN.CHECKPOINT_FILE_PATH:
        logger.info("Load from given checkpoint file %s.", cfg.TRAIN.CHECKPOINT_FILE_PATH)
        return load_checkpoint(
            cfg.TRAIN.CHECKPOINT_FILE_PATH, state,
            epoch_reset=cfg.TRAIN.CHECKPOINT_EPOCH_RESET,
            clear_name_pattern=list(cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN),
            checkpoint_type=cfg.TRAIN.CHECKPOINT_TYPE,
            inflate=cfg.TRAIN.CHECKPOINT_INFLATE,
            before_load=before_load,
        ) + 1
    return 0


def load_test_checkpoint(cfg, model):
    """The test-time priority chain (`checkpoint.py:667-704`); returns the
    path loaded, or None for the random init."""
    if cfg.TEST.CHECKPOINT_FILE_PATH:
        path, kind = cfg.TEST.CHECKPOINT_FILE_PATH, cfg.TEST.CHECKPOINT_TYPE
    elif has_checkpoint(cfg.OUTPUT_DIR, cfg.TASK):
        path, kind = get_last_checkpoint(cfg.OUTPUT_DIR, cfg.TASK), "pytorch"
    elif cfg.TRAIN.CHECKPOINT_FILE_PATH:
        path, kind = cfg.TRAIN.CHECKPOINT_FILE_PATH, cfg.TRAIN.CHECKPOINT_TYPE
    else:
        logger.info("Unknown way of loading checkpoint; using random initialization.")
        return None
    logger.info("Load test checkpoint %s.", path)
    load_checkpoint(path, model=model, checkpoint_type=kind)
    return path
