"""Logging: named loggers under ``pmv_tpu_torch`` and ``json_stats`` lines
(the reference's machine-readable log, `MViT/slowfast/utils/logging.py`)."""

import decimal
import json
import logging


def get_logger(name):
    return logging.getLogger("pmv_tpu_torch." + name if name else "pmv_tpu_torch")


def log_json_stats(stats, logger=None):
    """Log a dict as one ``json_stats: {...}`` line."""
    stats = {
        k: float(decimal.Decimal(f"{v:.5f}")) if isinstance(v, float) else v
        for k, v in stats.items()
    }
    json_stats = json.dumps(stats, sort_keys=True, default=str)
    (logger or get_logger("")).info("json_stats: %s", json_stats)
