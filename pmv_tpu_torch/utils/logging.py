"""Logging: named loggers under ``pmv_tpu_torch`` and ``json_stats`` lines
(the reference's machine-readable log, `MViT/slowfast/utils/logging.py`).

``setup_logging`` sends the ``pmv_tpu_torch`` logger to standard output and
to ``OUTPUT_DIR/stdout.log`` on rank 0 (the ``torch.distributed`` rank, 0
when it is not initialised); the other ranks log nothing.
"""

import decimal
import json
import logging
import os
import sys

from pmv_tpu_torch.utils.device import rank_and_world_size

_FORMAT = "[%(asctime)s][%(levelname)s] %(filename)s: %(lineno)3d: %(message)s"


def get_logger(name):
    return logging.getLogger("pmv_tpu_torch." + name if name else "pmv_tpu_torch")


def is_master_process():
    return rank_and_world_size()[0] == 0


def setup_logging(output_dir=None):
    """Point the package's logger at standard output and
    ``output_dir/stdout.log`` (rank 0 only). Calling it again replaces the
    handlers of the last call, so that each job logs to its own directory."""
    logger = get_logger("")
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not is_master_process():
        logger.addHandler(logging.NullHandler())
        return logger
    formatter = logging.Formatter(_FORMAT, datefmt="%m/%d %H:%M:%S")
    handlers = [logging.StreamHandler(stream=sys.stdout)]
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(output_dir, "stdout.log")))
    for handler in handlers:
        handler.setFormatter(formatter)
        logger.addHandler(handler)
    return logger


def log_json_stats(stats, logger=None):
    """Log a dict as one ``json_stats: {...}`` line."""
    stats = {
        k: float(decimal.Decimal(f"{v:.5f}")) if isinstance(v, float) else v
        for k, v in stats.items()
    }
    json_stats = json.dumps(stats, sort_keys=True, default=str)
    (logger or get_logger("")).info("json_stats: %s", json_stats)
