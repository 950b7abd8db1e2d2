"""Multi-view testing (`MViT/tools/test_net.py:27-381`).

Counterpart of `pmv_tpu/engine/test.py`.

- ``perform_test``: every batch holds clips that are each one (temporal
  view, spatial crop) of a video; per-clip scores are ensembled per video
  in the TestMeter. A batch with portrait rows ("pm") hands them to the
  eval step, which runs them through the portrait specialization.
- ``test_one``: one pass over the test loader, and TEST.SAVE_RESULTS_PATH.
  With DATA.MULTI_LABEL (Charades) a video's views ensemble by
  DATA.ENSEMBLE_METHOD ("max" or "sum") and the result is mAP; a video's
  label vector must be the same in each of its views, as in the JAX
  package (the TestMeter raises otherwise).
- ``extract_features``: TEST.FEAT_EXTRACT, pooled features to
  ``OUTPUT_DIR/features.npz``.
- ``visualize_mask_reconstruction``: VIS_MASK.ENABLE with a MaskMViT,
  the MAE (original | masked | reconstructed) stacks.
- ``test_detection``: DETECTION.ENABLE (AVA), one pass of the detection
  eval step over the test split's keyframes into an ``AVAMeter``, whose
  mAP is the result (`pmv_tpu/engine/test.py:83-166`); without the
  annotations' GROUNDTRUTH_FILE the groundtruth is the batches' own boxes
  and labels (``perform_detection``).
- ``test``: TEST.PROCESS, the checkpoint priority chain, then VIS_MASK,
  detection, features, the DENSE_SPATIAL_CROP ratio sweep
  (`test_net.py:358-379`) or one pass.

In a multi-process job every rank runs its shard of the test split with the
whole model (read from the same checkpoint), and the predictions, labels
and clip indices of each step are gathered across ranks into every rank's
TestMeter (the JAX package's ``process_allgather``, `test.py:31-36,
52-54`), so each clip is scored once; rank 0 logs and writes the results.
Shards of unequal length are handled: a rank whose shard ran out runs its
last batch again and contributes nothing (``distributed.lockstep``).
TENSORBOARD.ENABLE opens a writer only in the VIS_MASK path, as in the JAX
package's ``test``; there, rank 0 writes the stacks of its shard's batches.
Detection gathers each step's scores, original boxes and metadata (and
labels, for the groundtruth from the batches) of the valid boxes alike.
Under TPU.SHARD_STRATEGY dp_sp the ranks of a model group score the same
clips (``parallel/mesh.py``), each on its frames of them: only model rank 0
of each adds them to the gather, so that each clip is counted once; so
with detection's boxes (the JAX package's test places the frames by batch
only, `pmv_tpu/engine/test.py:42`: the numbers are the same) and the
extracted features. VIS_MASK runs every rank's model on whole clips.
"""

import os
import pickle
import pprint
import time
from collections import defaultdict

import numpy as np
import torch

from pmv_tpu_torch.data import loader as loader_mod
from pmv_tpu_torch.engine import steps
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.models.masked import mae_visualize
from pmv_tpu_torch.parallel import distributed, mesh
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils import meters as meters_mod
from pmv_tpu_torch.utils import misc
from pmv_tpu_torch.utils.ava_eval import make_image_key
from pmv_tpu_torch.utils.device import resolve_device

logger = pmv_logging.get_logger(__name__)


def perform_test(test_loader, eval_step, test_meter, lay=None):
    """Run ``eval_step`` over ``test_loader`` (any iterable of dicts with
    "frames", "labels" and "index", "pm" where rows may be portrait, and
    "audio" for AVSlowFast) and ensemble into ``test_meter``. Returns (test_meter, final stats).
    In a multi-process job each step's clips are gathered from every rank;
    under the sequence parallelism of ``lay`` (a ``mesh.Layout``) from model
    rank 0 of each model group."""
    test_meter.iter_tic()
    for cur_iter, (batch, real) in enumerate(distributed.lockstep(test_loader)):
        test_meter.data_toc()
        audio = {"audio": batch["audio"]} if "audio" in batch else {}
        if np.any(batch.get("pm", False)):
            preds = eval_step(batch["frames"], batch["pm"], **audio)
        else:
            preds = eval_step(batch["frames"], **audio)
        preds = preds.float().cpu().numpy()  # waits for the device
        test_meter.iter_toc()
        keep = slice(None) if real and (lay is None or lay.model == 0) else slice(0)
        preds, labels, index = distributed.gather_host(
            [preds[keep], np.asarray(batch["labels"])[keep], np.asarray(batch["index"])[keep]])
        test_meter.update_stats(preds, labels, index)
        test_meter.log_iter_stats(cur_iter)
        test_meter.iter_tic()
    stats = test_meter.finalize_metrics()
    return test_meter, stats


def add_batch_groundtruth(groundtruth, labels, ori_boxes, metadata, video_idx_to_name):
    """Add boxes' multi-hot ``labels`` [K, C] to ``groundtruth`` (boxes,
    labels, scores by image key, as ``ava_eval.read_csv`` returns them):
    class column c is action id c + 1, the box [y1, x1, y2, x2] of
    ``ori_boxes``, the key of ``metadata``'s (video index, second)."""
    for k in range(len(labels)):
        video, sec = int(metadata[k][0]), int(metadata[k][1])
        name = video_idx_to_name[video] if video_idx_to_name is not None else str(video)
        key = make_image_key(name, sec)
        y1, x1, y2, x2 = ori_boxes[k][[1, 0, 3, 2]]
        for c in np.nonzero(labels[k])[0]:
            groundtruth[0][key].append([y1, x1, y2, x2])
            groundtruth[1][key].append(int(c) + 1)
            groundtruth[2][key].append(1.0)


def perform_detection(loader, eval_step, meter, cur_epoch=None, lay=None):
    """Run the detection ``eval_step`` (``steps.make_detection_eval_step``)
    over ``loader`` (batches of ``Ava``'s keys) into the ``AVAMeter``: each
    step's valid boxes' scores, original boxes and metadata, gathered from
    every rank (under the sequence parallelism of ``lay``, a
    ``mesh.Layout``, from model rank 0 of each model group, as
    ``perform_test``). Returns the groundtruth of the batches' own boxes and
    labels where the meter has no GROUNDTRUTH_FILE, else None."""
    from_batches = meter.full_groundtruth is None
    groundtruth = (defaultdict(list), defaultdict(list), defaultdict(list))
    meter.iter_tic()
    for cur_iter, (batch, real) in enumerate(distributed.lockstep(loader)):
        meter.data_toc()
        scores = eval_step(batch["frames"], batch["boxes"], batch["box_mask"])
        scores = scores.float().cpu().numpy()  # waits for the device
        counted = real and (lay is None or lay.model == 0)
        b_idx, m_idx = np.nonzero(np.asarray(batch["box_mask"], bool) & counted)
        preds, ori, metadata, labels = distributed.gather_host([
            scores[b_idx, m_idx], np.asarray(batch["ori_boxes"], np.float32)[b_idx, m_idx],
            np.asarray(batch["metadata"])[b_idx],
            np.asarray(batch["labels"], np.float32)[b_idx, m_idx]])
        meter.iter_toc()
        meter.update_stats(preds, ori, metadata)
        if from_batches:
            add_batch_groundtruth(groundtruth, labels, ori, metadata, meter.video_idx_to_name)
        meter.log_iter_stats(cur_epoch, cur_iter)
        meter.iter_tic()
    return groundtruth if from_batches else None


def test_detection(cfg, model, device):
    """AVA's test: ``perform_detection`` over the test split into a test
    ``AVAMeter``; logs and returns {"map": the AVA mAP}."""
    test_loader = loader_mod.construct_loader(cfg, "test")
    eval_step = steps.make_detection_eval_step(cfg, model, device=device)
    meter = meters_mod.AVAMeter(len(test_loader), cfg, mode="test",
                                video_idx_to_name=getattr(test_loader.dataset,
                                                          "_video_names", None))
    tic = time.perf_counter()
    groundtruth = perform_detection(test_loader, eval_step, meter, lay=mesh.layout(cfg))
    logger.info("AVA test: %d keyframes in %.4fs", len(test_loader.dataset),
                time.perf_counter() - tic)
    mean_ap = meter.finalize_metrics(log=False, groundtruth=groundtruth)
    logger.info("AVA mAP: %.4f", mean_ap)
    pmv_logging.log_json_stats({"split": "test_final", "map": mean_ap}, logger)
    return {"map": mean_ap}


def extract_features(cfg, model, device):
    """TEST.FEAT_EXTRACT: pooled backbone features of every test clip to
    ``OUTPUT_DIR/features.npz`` (rank 0 writes; under dp_sp model rank 0's
    of each model group are gathered, whose ranks pool the same clips)."""
    test_loader = loader_mod.construct_loader(cfg, "test")
    feat_step = steps.make_feat_step(cfg, model, device=device)
    lay = mesh.layout(cfg)
    feats, indices = [], []
    for batch, real in distributed.lockstep(test_loader):
        keep = slice(None) if real and lay.model == 0 else slice(0)
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
    test_meter, stats = perform_test(test_loader, eval_step, test_meter, mesh.layout(cfg))

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


def visualize_mask_reconstruction(cfg, model, device):
    """VIS_MASK.ENABLE with a MaskMViT (`pmv_tpu/engine/test.py:216-262`,
    the reference's `test_net.py:140` and `masked.py:505-535`): for the
    first 4 test batches, the frames as they are (uint8 values as float, no
    normalisation, as the JAX package feeds them), a mask the model draws
    (its generator seeded from (RNG_SEED, the batch's index)), and the
    (original | masked | reconstructed) stack of ``mae_visualize``, written
    to ``OUTPUT_DIR/vis_mask_{iter:04d}.npy`` and, with TENSORBOARD.ENABLE,
    as a video, by rank 0. Returns the paths written."""
    test_loader = loader_mod.construct_loader(cfg, "test")
    master = pmv_logging.is_master_process()
    writer = None
    if cfg.TENSORBOARD.ENABLE and master:
        from pmv_tpu_torch.visualization.tensorboard_vis import TensorboardWriter

        writer = TensorboardWriter(cfg)
    model.eval()
    generator = torch.Generator(device)
    out_paths = []
    for cur_iter, batch in enumerate(test_loader):
        x = torch.as_tensor(batch["frames"]).to(device).float()
        generator.manual_seed(int(np.random.SeedSequence(
            (cfg.RNG_SEED, cur_iter)).generate_state(1)[0]))
        with torch.inference_mode():
            mask = model.sample_mask(tuple(x.shape), generator, device)
            pred, _, mask = model(x, mask)
            comp = mae_visualize(cfg, x, pred, mask).cpu().numpy()
        path = os.path.join(cfg.OUTPUT_DIR, f"vis_mask_{cur_iter:04d}.npy")
        if master:
            np.save(path, comp)
            out_paths.append(path)
        if writer is not None:
            b, three, t, h, w, c = comp.shape
            writer.add_video(comp.reshape(b * three, t, h, w, c)[:6],
                             tag="mae_reconstruction", global_step=cur_iter)
        if cur_iter >= 3:  # a bounded sweep
            break
    if writer is not None:
        writer.close()
    logger.info("VIS_MASK wrote %d comparison stacks", len(out_paths))
    return out_paths


def test(cfg, device=None):
    """Multi-view test entry (`tools/test_net.py` test) on ``device`` (CUDA
    by default; raises without a CUDA device unless ``device="cpu"``)."""
    device = resolve_device(device)
    pmv_logging.setup_logging(cfg.OUTPUT_DIR)
    distributed.check_world(cfg)
    distributed.check_sequence_parallel(cfg)
    np.random.seed(cfg.RNG_SEED)
    torch.manual_seed(cfg.RNG_SEED)
    logger.info("Test with config:")
    logger.info(pprint.pformat(cfg))
    cfg = cfg.clone()
    cfg.TEST.PROCESS = True

    model = build_model(cfg, device=device, seed=cfg.RNG_SEED)
    if cfg.LOG_MODEL_INFO:
        misc.log_model_info(model, cfg)
    cu.load_test_checkpoint(cfg, model)

    if cfg.VIS_MASK.ENABLE and cfg.MODEL.MODEL_NAME == "MaskMViT":
        return visualize_mask_reconstruction(cfg, model, device)
    if cfg.DETECTION.ENABLE:
        return test_detection(cfg, model, device)
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
