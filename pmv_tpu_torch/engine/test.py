"""Multi-view testing (`MViT/tools/test_net.py:27-381`).

perform_test: every batch holds clips that are each one (temporal view,
spatial crop) of a video; per-clip scores are ensembled per video in the
TestMeter. The test loader, checkpoint loading, the portrait (``pm``) eval
step and the multi-host gather are not ported yet.
"""

import numpy as np


def perform_test(test_loader, eval_step, test_meter):
    """Run ``eval_step`` over ``test_loader`` (any iterable of dicts with
    "frames", "labels" and "index") and ensemble into ``test_meter``.
    Returns (test_meter, final stats)."""
    test_meter.iter_tic()
    for cur_iter, batch in enumerate(test_loader):
        test_meter.data_toc()
        preds = eval_step(batch["frames"])
        preds = preds.float().cpu().numpy()  # waits for the device
        test_meter.iter_toc()
        test_meter.update_stats(
            preds, np.asarray(batch["labels"]), np.asarray(batch["index"])
        )
        test_meter.log_iter_stats(cur_iter)
        test_meter.iter_tic()
    stats = test_meter.finalize_metrics()
    return test_meter, stats
