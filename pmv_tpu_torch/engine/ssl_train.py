"""Self-supervised training (`pmv_tpu/engine/ssl_train.py`, the reference's
`train_net.py:140-159` branches).

``train_ssl`` trains a MaskMViT (MaskFeat pre-training) as the JAX
package's ``train_ssl`` does: the model from RNG_SEED, its optimizer, the
train loader, a TrainMeter, auto-resume from the last checkpoint (weights,
optimizer state, epoch), then per epoch ``engine.train.train_epoch`` over
the masked train step (the LR of ``get_lr_at_epoch`` at every iteration,
the NaN guard) and a ``.pyth`` checkpoint per ``is_checkpoint_epoch``. The
loop is the supervised one's: the step's metrics stay on the device until
every LOG_PERIOD-th iteration, where the host reads them and raises on a
NaN loss, before any checkpoint of poisoned weights is written (the JAX
loop reads them at every iteration).

The JAX loop reads no ``pm`` flag: a portrait row runs as it comes, and so
here. There is no evaluation. Not ported, each raising NotImplementedError:
the ContrastiveModel branch with its kNN monitor (M16), and SSL over more
than one process (NUM_GPUS x NUM_SHARDS > 1), queued with M16 (ROADMAP.md).
"""

import pprint

import numpy as np
import torch

from pmv_tpu_torch.data import loader as loader_mod
from pmv_tpu_torch.engine import ssl_steps
from pmv_tpu_torch.engine.train import refuse_unported, train_epoch
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.parallel import distributed
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils import meters as meters_mod
from pmv_tpu_torch.utils import misc
from pmv_tpu_torch.utils.device import resolve_device

logger = pmv_logging.get_logger(__name__)

SSL_MODELS = ("ContrastiveModel", "MaskMViT")


def refuse_unported_ssl(cfg):
    """Raise for the SSL runs the port does not have: the contrastive model,
    and any SSL model over more than one process."""
    if cfg.MODEL.MODEL_NAME == "ContrastiveModel":
        raise NotImplementedError("ContrastiveModel (contrastive SSL) is not ported")
    if distributed.world_size_of(cfg) > 1:
        raise NotImplementedError(
            "SSL training over more than one process (NUM_GPUS x NUM_SHARDS > 1) is "
            "not ported: set NUM_GPUS 1"
        )


def train_ssl(cfg, device=None):
    """Train ``cfg``'s SSL model on ``device`` (CUDA by default; raises
    without a CUDA device unless ``device="cpu"``). Returns the state."""
    device = resolve_device(device)
    refuse_unported_ssl(cfg)
    pmv_logging.setup_logging(cfg.OUTPUT_DIR)
    refuse_unported(cfg)
    np.random.seed(cfg.RNG_SEED)
    torch.manual_seed(cfg.RNG_SEED)
    logger.info("SSL train (%s) with config:", cfg.MODEL.MODEL_NAME)
    logger.info(pprint.pformat(cfg))

    model = build_model(cfg, device=device, seed=cfg.RNG_SEED)
    if cfg.LOG_MODEL_INFO:
        misc.log_model_info(model)
    state = ssl_steps.init_masked_state(cfg, model)
    train_step = ssl_steps.make_masked_train_step(cfg, device=device, seed=cfg.RNG_SEED)
    train_loader = loader_mod.construct_loader(cfg, "train")
    meter = meters_mod.TrainMeter(len(train_loader), cfg)

    start_epoch = 0
    if cfg.TRAIN.AUTO_RESUME and cu.has_checkpoint(cfg.OUTPUT_DIR, cfg.TASK):
        last = cu.get_last_checkpoint(cfg.OUTPUT_DIR, cfg.TASK)
        start_epoch = cu.load_checkpoint(last, state) + 1
        logger.info("Resumed SSL training from %s", last)

    logger.info("Start epoch: %d", start_epoch + 1)
    for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        train_loader.set_epoch(cur_epoch)
        train_epoch(train_loader, train_step, state, meter, cur_epoch, cfg)
        if cu.is_checkpoint_epoch(cfg, cur_epoch):
            cu.save_checkpoint(cfg.OUTPUT_DIR, state, cur_epoch, cfg)
    return state
