"""Multi-view testing (`MViT/tools/test_net.py:27-381`).

Counterpart of `pmv_tpu/engine/test.py`.

- ``perform_test``: every batch holds clips that are each one (temporal
  view, spatial crop) of a video; per-clip scores are ensembled per video
  in the TestMeter. A batch with portrait rows ("pm") hands them to the
  eval step, which runs them through the portrait specialization.
- ``test_one``: one pass over the test loader, and TEST.SAVE_RESULTS_PATH.
- ``extract_features``: TEST.FEAT_EXTRACT, pooled features to
  ``OUTPUT_DIR/features.npz``.
- ``test``: TEST.PROCESS, the checkpoint priority chain, then features, the
  DENSE_SPATIAL_CROP ratio sweep (`test_net.py:358-379`) or one pass.

In a multi-process job every rank runs its shard of the test split with the
whole model (read from the same checkpoint), and the predictions, labels
and clip indices of each step are gathered across ranks into every rank's
TestMeter (the JAX package's ``process_allgather``, `test.py:31-36,
52-54`), so each clip is scored once; rank 0 logs and writes the results.
Shards of unequal length are handled: a rank whose shard ran out runs its
last batch again and contributes nothing (``distributed.lockstep``).
TENSORBOARD.ENABLE opens no writer here: the JAX package's ``test`` writes
only in its VIS_MASK path.

Not ported, each raising NotImplementedError: detection (AVA) and VIS_MASK.
"""

import os
import pickle
import pprint

import numpy as np
import torch

from pmv_tpu_torch.data import loader as loader_mod
from pmv_tpu_torch.engine import steps
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.parallel import distributed
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils import meters as meters_mod
from pmv_tpu_torch.utils import misc
from pmv_tpu_torch.utils.device import resolve_device

logger = pmv_logging.get_logger(__name__)


def perform_test(test_loader, eval_step, test_meter):
    """Run ``eval_step`` over ``test_loader`` (any iterable of dicts with
    "frames", "labels" and "index", and "pm" where rows may be portrait)
    and ensemble into ``test_meter``. Returns (test_meter, final stats).
    In a multi-process job each step's clips are gathered from every rank."""
    test_meter.iter_tic()
    for cur_iter, (batch, real) in enumerate(distributed.lockstep(test_loader)):
        test_meter.data_toc()
        if np.any(batch.get("pm", False)):
            preds = eval_step(batch["frames"], batch["pm"])
        else:
            preds = eval_step(batch["frames"])
        preds = preds.float().cpu().numpy()  # waits for the device
        test_meter.iter_toc()
        keep = slice(None) if real else slice(0)
        preds, labels, index = distributed.gather_host(
            [preds[keep], np.asarray(batch["labels"])[keep], np.asarray(batch["index"])[keep]])
        test_meter.update_stats(preds, labels, index)
        test_meter.log_iter_stats(cur_iter)
        test_meter.iter_tic()
    stats = test_meter.finalize_metrics()
    return test_meter, stats


def extract_features(cfg, model, device):
    """TEST.FEAT_EXTRACT: pooled backbone features of every test clip to
    ``OUTPUT_DIR/features.npz`` (rank 0 writes)."""
    test_loader = loader_mod.construct_loader(cfg, "test")
    feat_step = steps.make_feat_step(cfg, model, device=device)
    feats, indices = [], []
    for batch, real in distributed.lockstep(test_loader):
        keep = slice(None) if real else slice(0)
        feat, index = distributed.gather_host(
            [feat_step(batch["frames"]).cpu().numpy()[keep], np.asarray(batch["index"])[keep]])
        feats.append(feat)
        indices.append(index)
    out = {"features": np.concatenate(feats), "index": np.concatenate(indices)}
    if pmv_logging.is_master_process():
        path = os.path.join(cfg.OUTPUT_DIR, "features.npz")
        np.savez(path, **out)
        logger.info("Features saved to %s", path)
    return out


def test_one(cfg, model, device, rel_ratio=None):
    """One multi-view pass over the test split; returns the final stats."""
    test_loader = loader_mod.construct_loader(cfg, "test")
    logger.info("Testing model for %d iterations", len(test_loader))
    views = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    if len(test_loader.dataset) % views:
        raise ValueError("the test set's size must divide by the view protocol")
    test_meter = meters_mod.TestMeter(
        len(test_loader.dataset) // views,
        views,
        cfg.MODEL.NUM_CLASSES,
        len(test_loader),
        multi_label=cfg.DATA.MULTI_LABEL,
        ensemble_method=cfg.DATA.ENSEMBLE_METHOD,
    )
    eval_step = steps.make_eval_step(cfg, model, device=device)
    test_meter, stats = perform_test(test_loader, eval_step, test_meter)

    if cfg.TEST.SAVE_RESULTS_PATH and pmv_logging.is_master_process():
        tag = "" if rel_ratio is None else f"_r{rel_ratio[0]:.2f}x{rel_ratio[1]:.2f}"
        save_path = os.path.join(cfg.OUTPUT_DIR, cfg.TEST.SAVE_RESULTS_PATH + tag)
        with open(save_path, "wb") as f:
            pickle.dump(
                {"video_preds": test_meter.video_preds,
                 "video_labels": test_meter.video_labels},
                f,
            )
        logger.info("Testing results saved to %s", save_path)
    return stats


def test(cfg, device=None):
    """Multi-view test entry (`tools/test_net.py` test) on ``device`` (CUDA
    by default; raises without a CUDA device unless ``device="cpu"``)."""
    device = resolve_device(device)
    pmv_logging.setup_logging(cfg.OUTPUT_DIR)
    distributed.check_world(cfg)
    if cfg.DETECTION.ENABLE:
        raise NotImplementedError("detection (AVA) testing is not ported")
    if cfg.VIS_MASK.ENABLE:
        raise NotImplementedError("VIS_MASK is not ported")
    np.random.seed(cfg.RNG_SEED)
    torch.manual_seed(cfg.RNG_SEED)
    logger.info("Test with config:")
    logger.info(pprint.pformat(cfg))
    cfg = cfg.clone()
    cfg.TEST.PROCESS = True

    model = build_model(cfg, device=device, seed=cfg.RNG_SEED)
    if cfg.LOG_MODEL_INFO:
        misc.log_model_info(model)
    cu.load_test_checkpoint(cfg, model)

    if cfg.TEST.FEAT_EXTRACT:
        return extract_features(cfg, model, device)
    if cfg.TEST.DENSE_SPATIAL_CROP:
        grid = np.linspace(0, 1, cfg.TEST.DENSE_SPATIAL_CROP_STEPS)
        all_stats = []
        for rh in grid:
            for rw in grid:
                sweep_cfg = cfg.clone()
                sweep_cfg.TEST.SPATIAL_SAMPLE_INDEX = -2
                sweep_cfg.TEST.SPATIAL_SAMPLE_RATIO = [float(rh), float(rw)]
                sweep_cfg.TEST.NUM_SPATIAL_CROPS = 1
                all_stats.append(test_one(sweep_cfg, model, device, rel_ratio=(rh, rw)))
        return all_stats
    return test_one(cfg, model, device)
