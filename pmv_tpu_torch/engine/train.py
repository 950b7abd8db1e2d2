"""The per-epoch training loop (`MViT/tools/train_net.py:33-310`).

Counterpart of `pmv_tpu/engine/train.py::train_epoch`. Each iteration takes
its LR from ``lr_policy`` at the fractional epoch ``cur_epoch + iter / len``
and runs the train step; the step's metrics stay on the device until a flush
every LOG_PERIOD iterations (and at the end of the epoch), where the host
reads them, runs the NaN guard and the loss-explosion guard, and feeds the
TrainMeter. So up to LOG_PERIOD - 1 steps may run after a bad one before the
guard raises, the price of not waiting for the device every step.

Not ported yet: the profiler window, the device prefetcher, the portrait
(``pm``) step and the audio batches.
"""

import numpy as np

from pmv_tpu_torch.utils.lr_policy import get_lr_at_epoch


def train_epoch(train_loader, train_step, state, meter, cur_epoch, cfg):
    """One epoch over ``train_loader`` (any sized iterable of batches with
    "frames" and "labels"). Returns ``state``, updated in place."""
    data_size = len(train_loader)
    pending = []
    flush_every = max(1, cfg.LOG_PERIOD)

    def flush_metrics():
        for it, lr_it, mb_size, m in pending:
            m = {k: v.item() for k, v in m.items()}  # waits for the device
            if m["nan"]:
                raise RuntimeError(f"ERROR: Got NaN losses at iter {it}")
            if (
                cfg.TRAIN.KILL_LOSS_EXPLOSION_FACTOR > 0.0
                and meter.loss.count > 10
                and m["loss"]
                > cfg.TRAIN.KILL_LOSS_EXPLOSION_FACTOR * meter.loss.get_global_avg()
            ):
                raise RuntimeError(f"ERROR: Got Loss explosion of {m['loss']}")
            meter.update_stats(
                m["top1_err"], m["top5_err"], m["loss"], lr_it, m["grad_norm"],
                mb_size * max(cfg.NUM_SHARDS, 1),
            )
            meter.log_iter_stats(cur_epoch, it)
        pending.clear()

    meter.iter_tic()
    for cur_iter, batch in enumerate(train_loader):
        if "pm" in batch and np.any(batch["pm"]):
            raise NotImplementedError("portrait (pm) batches are not ported yet")
        epoch_exact = cur_epoch + float(cur_iter) / data_size
        lr = get_lr_at_epoch(cfg, epoch_exact)
        meter.data_toc()
        metrics = train_step(state, batch, lr)
        pending.append((cur_iter, lr, batch["frames"].shape[0], metrics))
        meter.iter_toc()
        if (cur_iter + 1) % flush_every == 0:
            flush_metrics()
        meter.iter_tic()
    flush_metrics()
    meter.log_epoch_stats(cur_epoch)
    meter.reset()
    return state
