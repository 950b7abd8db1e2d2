"""Data-loading benchmark (`MViT/slowfast/utils/benchmark.py:20-103`).

The port's own copy of `pmv_tpu/utils/benchmark.py`: it iterates the train
loader (``data/loader.py``: decode or synthesis, resize, crop and collate
on the host's threads) for BENCHMARK.NUM_EPOCHS epochs without touching
the model or the device, reshuffling each epoch when BENCHMARK.SHUFFLE,
and logs every BENCHMARK.LOG_PERIOD batches the median s/batch over the
window, the clips/s over the window (the batches' own sizes: this
process's share of TRAIN.BATCH_SIZE, and a multigrid short cycle's sizes)
and the process's resident memory; at the end, the highest resident
memory it saw after a batch. It isolates the input pipeline's throughput
from the step's.
"""

import os
import resource

from pmv_tpu_torch.data import loader as loader_mod
from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils.meters import ScalarMeter
from pmv_tpu_torch.utils.timer import Timer

logger = pmv_logging.get_logger(__name__)


def rss_gb():
    """This process's resident memory now, in GB: /proc/self/statm where
    the system has it, else the peak ``ru_maxrss`` (which survives exec on
    Linux, so that a process started from a larger one reads that one's)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1024 ** 3
    except (OSError, IndexError, ValueError):
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024 ** 2


def benchmark_data_loading(cfg):
    """Run the benchmark; returns (the mean s/batch over every batch, the
    clips loaded)."""
    pmv_logging.setup_logging(cfg.OUTPUT_DIR)
    logger.info("Benchmarking data loading with config:")
    logger.info(cfg.dump())

    timer = Timer()
    train_loader = loader_mod.construct_loader(cfg, "train")
    logger.info("Constructed loader: %d batches of %d", len(train_loader), cfg.TRAIN.BATCH_SIZE)
    batch_times = ScalarMeter(cfg.BENCHMARK.LOG_PERIOD)
    batch_clips = ScalarMeter(cfg.BENCHMARK.LOG_PERIOD)
    total, peak = 0, rss_gb()
    for epoch in range(cfg.BENCHMARK.NUM_EPOCHS):
        if cfg.BENCHMARK.SHUFFLE:
            train_loader.set_epoch(epoch)
        timer.reset()
        for cur_iter, batch in enumerate(train_loader):
            batch_times.add_value(timer.seconds())
            timer.reset()
            batch_clips.add_value(batch["frames"].shape[0])
            total += batch["frames"].shape[0]
            ram = rss_gb()
            peak = max(peak, ram)
            if (cur_iter + 1) % cfg.BENCHMARK.LOG_PERIOD == 0:
                logger.info(
                    "epoch %d iter %d: %.4f s/batch (%.1f clips/s), RAM %.2f GB",
                    epoch, cur_iter + 1, batch_times.get_win_median(),
                    batch_clips.get_win_avg() / max(batch_times.get_win_avg(), 1e-9), ram,
                )
    logger.info("Benchmark complete: %d clips loaded, %.4f s/batch, %.1f clips/s, RAM %.2f GB",
                total, batch_times.get_global_avg(),
                total / max(batch_times.total, 1e-9), peak)
    return batch_times.get_global_avg(), total
