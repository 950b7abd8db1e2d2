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


def is_eval_epoch(cfg, cur_epoch, multigrid_schedule=None):
    """Eval on EVAL_PERIOD boundaries and at the final epoch; under multigrid
    long cycles (``multigrid_schedule``), EVAL_FREQ times a cycle, aligned
    to the cycle's end (`misc.py:228-250`)."""
    if cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH:
        return True
    if multigrid_schedule is not None:
        prev_epoch = 0
        for s in multigrid_schedule:
            if cur_epoch < s[-1]:
                period = max((s[-1] - prev_epoch) // cfg.MULTIGRID.EVAL_FREQ + 1, 1)
                return (s[-1] - 1 - cur_epoch) % period == 0
            prev_epoch = s[-1]
    return (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0
