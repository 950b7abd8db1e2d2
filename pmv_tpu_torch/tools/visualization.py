"""Model and wrong-prediction visualization (`MViT/tools/visualization.py:
29-345`; the JAX package's `tools/visualization.py:15-118`).

``visualize(cfg, device)``, which ``run_net`` calls after train and test
where TENSORBOARD.ENABLE and MODEL_VIS or WRONG_PRED_VIS ask for it:

- TENSORBOARD.PREDICTIONS_PATH: the confusion matrix and the top-k
  histograms (``TensorboardWriter.plot_eval``) of a pickle that ``test()``
  wrote (TEST.SAVE_RESULTS_PATH: {"video_preds", "video_labels"}) or of a
  (preds, labels) tuple, the reference's; then done, unless MODEL_VIS or
  WRONG_PRED_VIS is on;
- the model from the test checkpoint (``load_test_checkpoint``);
- MODEL_VIS.MODEL_WEIGHTS: a histogram of each parameter whose name starts
  with an entry of MODEL_VIS.LAYER_LIST (all where it is empty), tagged
  ``weights/<name>`` by the port's (the reference's) names, where the JAX
  package tags by its flax paths;
- over at most 5 test batches: Grad-CAM (``visualization/gradcam.py``,
  unless MODEL_VIS is on with GRAD_CAM off), of the true labels with
  GRAD_CAM.USE_TRUE_LABEL, whose maps are computed and not written, as in
  the JAX package; the first batch's frames as the "Input" video (unless
  MODEL_VIS is on with INPUT_VIDEO off); with WRONG_PRED_VIS the frames of
  up to 4 misclassified clips a batch under WRONG_PRED_VIS.TAG;
- then ``plot_eval`` over those batches' predictions.
"""

import pickle

import numpy as np
import torch

from pmv_tpu_torch.data import loader as loader_mod
from pmv_tpu_torch.engine import steps
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils.device import resolve_device
from pmv_tpu_torch.visualization.gradcam import gradcam
from pmv_tpu_torch.visualization.tensorboard_vis import TensorboardWriter

MAX_BATCHES = 5  # the sweep is bounded by design (`tools/visualization.py:110`)


def _plot_predictions_file(cfg):
    writer = TensorboardWriter(cfg)
    with open(cfg.TENSORBOARD.PREDICTIONS_PATH, "rb") as f:
        obj = pickle.load(f)
    if isinstance(obj, dict):  # test()'s dump (engine/test.py)
        preds, labels = obj["video_preds"], obj["video_labels"]
    else:  # the reference's (preds, labels) tuple
        preds, labels = obj
    writer.plot_eval(np.asarray(preds), np.asarray(labels), global_step=0)
    writer.close()


def weight_histograms(writer, model, layer_list):
    """``weights/<name>`` histograms of ``model``'s parameters whose names
    start with an entry of ``layer_list`` (flax-style "/" read as ".")."""
    prefixes = [layer.replace("/", ".") for layer in layer_list]
    for name, param in model.named_parameters():
        if prefixes and not any(name.startswith(p) for p in prefixes):
            continue
        writer.add_histogram(f"weights/{name}", param, global_step=0)


def visualize(cfg, device=None):
    """Visualize per ``cfg`` on ``device`` (CUDA by default; raises without a
    CUDA device unless ``device="cpu"``)."""
    device = resolve_device(device)
    pmv_logging.setup_logging(cfg.OUTPUT_DIR)
    cfg = cfg.clone()
    cfg.TEST.PROCESS = True
    if cfg.TENSORBOARD.PREDICTIONS_PATH:
        _plot_predictions_file(cfg)
        if not (cfg.TENSORBOARD.MODEL_VIS.ENABLE or cfg.TENSORBOARD.WRONG_PRED_VIS.ENABLE):
            return
    model = build_model(cfg, device=device, seed=cfg.RNG_SEED)
    test_loader = loader_mod.construct_loader(cfg, "test")
    cu.load_test_checkpoint(cfg, model)
    model.eval()
    writer = TensorboardWriter(cfg)
    preprocess = steps.make_eval_preprocess_fn(cfg, device)

    mv = cfg.TENSORBOARD.MODEL_VIS
    if mv.ENABLE and mv.MODEL_WEIGHTS:
        weight_histograms(writer, model, mv.LAYER_LIST)

    use_gradcam = not mv.ENABLE or mv.GRAD_CAM.ENABLE
    all_preds, all_labels = [], []
    for cur_iter, batch in enumerate(test_loader):
        labels = np.asarray(batch["labels"])
        x = preprocess(torch.as_tensor(batch["frames"]).to(device, non_blocking=True))
        if use_gradcam:
            target = labels if mv.ENABLE and mv.GRAD_CAM.USE_TRUE_LABEL else None
            _, preds = gradcam(model, x, target_labels=target)
        else:
            with torch.inference_mode():
                preds = model(steps.model_input(cfg, x))
        preds = preds.float().cpu().numpy()
        all_preds.append(preds)
        all_labels.append(labels)
        if cur_iter == 0 and (not mv.ENABLE or mv.INPUT_VIDEO):
            writer.add_video(batch["frames"], tag="Input", global_step=0)
        if cfg.TENSORBOARD.WRONG_PRED_VIS.ENABLE:
            wrong = preds.argmax(axis=-1) != labels
            if wrong.any():
                writer.add_video(np.asarray(batch["frames"])[wrong][:4],
                                 tag=cfg.TENSORBOARD.WRONG_PRED_VIS.TAG, global_step=cur_iter)
        if cur_iter + 1 >= MAX_BATCHES:
            break
    writer.plot_eval(np.concatenate(all_preds), np.concatenate(all_labels), global_step=0)
    writer.close()
