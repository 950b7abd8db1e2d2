"""Self-supervised training (`pmv_tpu/engine/ssl_train.py`, the reference's
`train_net.py:140-159` branches).

``train_ssl`` trains a MaskMViT (MaskFeat pre-training) or a
ContrastiveModel (MoCo, SimCLR, BYOL, SwAV, memory bank) as the JAX
package's ``train_ssl`` does: the model from RNG_SEED (the contrastive
model's SSL state with it: ``models/contrastive.py``), its optimizer, the
train loader, a TrainMeter, auto-resume from the last checkpoint (weights,
the SSL state, optimizer state, epoch), then per epoch
``engine.train.train_epoch`` over the SSL train step (the LR of
``get_lr_at_epoch`` at every iteration, the NaN guard) and a ``.pyth``
checkpoint per ``is_checkpoint_epoch``. The loop is the supervised one's:
the step's metrics stay on the device until every LOG_PERIOD-th iteration,
where the host reads them and raises on a NaN loss, before any checkpoint
of poisoned weights is written (the JAX loop reads them at every
iteration).

The kNN monitor (`ssl_train.py:52-88`): where the contrastive model has a
bank (CONTRASTIVE.KNN_ON, or TYPE "mem") and the train set has labels
(``dataset._labels``), at each ``is_eval_epoch`` the val loader runs
through the feature step, ``knn_predict`` scores each clip from the bank
(k = min(200, the bank's rows); the label of a bank row is the train
label at its sample index) and ``{"_type": "ssl_knn_epoch",
"knn_top1_acc": ...}`` is logged. The model is built from the config,
not from the loader's first batch: the JAX package's ``train_ssl``
initialises from that batch, which fails on a loader of multi-clip views
(ROADMAP.md).

The JAX loop reads no ``pm`` flag: a portrait row runs as it comes, and so
here. In a multi-process job (NUM_GPUS x NUM_SHARDS > 1) both SSL models
train under TPU.SHARD_STRATEGY "dp" or "fsdp" (``engine/ssl_steps.py``;
``distributed.wrap_model`` as ``engine/train.py`` calls it): each rank its
rows of the global batch, the kNN monitor's hits and counts summed over the
ranks, every rank running as many feature forwards as the longest shard
(``distributed.lockstep``: FSDP gathers in each). "dp_sp" with an SSL model
is not ported and raises NotImplementedError.
"""

import pprint

import numpy as np
import torch

from pmv_tpu_torch.data import loader as loader_mod
from pmv_tpu_torch.engine import ssl_steps
from pmv_tpu_torch.engine.train import refuse_unported, train_epoch
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.models import contrastive as cm
from pmv_tpu_torch.parallel import distributed
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils import meters as meters_mod
from pmv_tpu_torch.utils import misc
from pmv_tpu_torch.utils.device import rank_and_world_size, resolve_device

logger = pmv_logging.get_logger(__name__)

SSL_MODELS = ("ContrastiveModel", "MaskMViT")


def refuse_unported_ssl(cfg):
    """Raise for the SSL runs the port does not have: any SSL model over
    more than one process under "dp_sp"."""
    if distributed.world_size_of(cfg) > 1 and cfg.TPU.SHARD_STRATEGY == "dp_sp":
        raise NotImplementedError(
            "SSL training under TPU.SHARD_STRATEGY dp_sp is not ported (queued in "
            "ROADMAP.md): use dp or fsdp, or NUM_GPUS 1"
        )


def make_knn_eval(cfg, model, train_loader, device):
    """knn_eval(cur_epoch) -> the kNN top-1 accuracy in percent, or None
    when the model has no bank or the train set no labels."""
    labels = getattr(train_loader.dataset, "_labels", None)
    if not hasattr(model, "bank"):
        return None
    if labels is None:
        logger.warning("the train set has no _labels: the kNN monitor is off")
        return None
    bank_labels = torch.as_tensor(np.asarray(labels), device=device)
    val_loader = loader_mod.construct_loader(cfg, "val")
    feature_step = ssl_steps.make_ssl_feature_step(cfg, model, device)

    def knn_eval(cur_epoch):
        hits = torch.zeros((), dtype=torch.int64, device=device)
        seen = torch.zeros((), dtype=torch.int64, device=device)
        k = min(200, model.bank.shape[0])
        for batch, real in distributed.lockstep(val_loader):  # FSDP's gathers
            feats = feature_step(batch["frames"])
            if not real:
                continue
            scores = cm.knn_predict(model.bank, bank_labels, feats, cfg.MODEL.NUM_CLASSES, k=k)
            target = torch.as_tensor(batch["labels"], device=device)
            hits += (scores.argmax(dim=-1) == target).sum()
            seen += target.shape[0]
        hits, seen = distributed.all_reduce_sum(torch.stack([hits, seen])).tolist()
        acc = 100.0 * hits / max(seen, 1)
        pmv_logging.log_json_stats({"_type": "ssl_knn_epoch", "epoch": cur_epoch,
                                    "knn_top1_acc": round(acc, 2)})
        return acc

    return knn_eval


def train_ssl(cfg, device=None):
    """Train ``cfg``'s SSL model on ``device`` (CUDA by default; raises
    without a CUDA device unless ``device="cpu"``). Returns the state."""
    device = resolve_device(device)
    refuse_unported_ssl(cfg)
    pmv_logging.setup_logging(cfg.OUTPUT_DIR)
    distributed.check_world(cfg)
    refuse_unported(cfg)
    np.random.seed(cfg.RNG_SEED)
    torch.manual_seed(cfg.RNG_SEED)
    name = cfg.MODEL.MODEL_NAME
    logger.info("SSL train (%s) with config:",
                cfg.CONTRASTIVE.TYPE if name == "ContrastiveModel" else name)
    logger.info(pprint.pformat(cfg))

    model = build_model(cfg, device=device, seed=cfg.RNG_SEED)
    if cfg.LOG_MODEL_INFO:
        misc.log_model_info(model)
    wrapped = None
    if rank_and_world_size()[1] > 1:
        wrapped = distributed.wrap_model(model, cfg.TPU.SHARD_STRATEGY, device)
    if name == "MaskMViT":
        state = ssl_steps.init_masked_state(cfg, model, wrapped=wrapped)
        train_step = ssl_steps.make_masked_train_step(cfg, device=device, seed=cfg.RNG_SEED)
    else:
        state = ssl_steps.init_ssl_state(cfg, model, wrapped=wrapped)
        train_step = ssl_steps.make_ssl_train_step(cfg, device=device, seed=cfg.RNG_SEED)
    train_loader = loader_mod.construct_loader(cfg, "train")
    meter = meters_mod.TrainMeter(len(train_loader), cfg)

    start_epoch = 0
    if cfg.TRAIN.AUTO_RESUME and cu.has_checkpoint(cfg.OUTPUT_DIR, cfg.TASK):
        last = cu.get_last_checkpoint(cfg.OUTPUT_DIR, cfg.TASK)
        start_epoch = cu.load_checkpoint(last, state) + 1
        logger.info("Resumed SSL training from %s", last)
    knn_eval = None
    if name == "ContrastiveModel" and cfg.CONTRASTIVE.KNN_ON:
        knn_eval = make_knn_eval(cfg, model, train_loader, device)

    logger.info("Start epoch: %d", start_epoch + 1)
    for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        train_loader.set_epoch(cur_epoch)
        train_epoch(train_loader, train_step, state, meter, cur_epoch, cfg)
        if cu.is_checkpoint_epoch(cfg, cur_epoch):
            cu.save_checkpoint(cfg.OUTPUT_DIR, state, cur_epoch, cfg)
        if knn_eval is not None and misc.is_eval_epoch(cfg, cur_epoch):
            knn_eval(cur_epoch)
    return state
