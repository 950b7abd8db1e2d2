"""Model and schedule helpers (`pmv_tpu/utils/misc.py`,
`MViT/slowfast/utils/misc.py`).

``log_model_info`` logs the parameter count and the device memory. FLOP and
activation counts are not ported (the JAX package takes them from XLA's
cost model and jaxpr); it logs that, and no number.
"""

from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils.meters import gpu_mem_usage

logger = pmv_logging.get_logger(__name__)


def params_count(model):
    """Total parameter count of ``model``."""
    return sum(p.numel() for p in model.parameters())


def log_model_info(model):
    """Log params and memory at job start (`misc.py:166-226`)."""
    logger.info("Params: %s", f"{params_count(model):,}")
    logger.info("Mem: %.2f GB", gpu_mem_usage())
    logger.info("Flops and activations: not counted (not ported)")


def is_eval_epoch(cfg, cur_epoch):
    """Eval on EVAL_PERIOD boundaries and at the final epoch
    (`misc.py:228-250`; the multigrid schedule is not ported)."""
    return (
        cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH
        or (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0
    )
