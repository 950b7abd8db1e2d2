"""The port's TensorBoard writer against the JAX package's.

- ``TensorboardWriter.add_scalars`` writes the events the JAX package's
  writer writes for the same calls (tags, steps, values), read back with
  tensorboard's ``EventAccumulator``;
- ``train()`` with TENSORBOARD.ENABLE on configs/tiny_synthetic.yaml writes,
  after each evaluated epoch, the tags of the JAX package's ``train()``
  (`pmv_tpu/engine/train.py:372-380`): Val/Top1_err and Val/Top5_err at the
  epoch, equal to the epoch's val_epoch stats;
- only rank 0 writes: another rank's ``train()`` opens no writer;
- ``add_video`` (VIS_MASK's) writes what the JAX writer writes;
- ``add_histogram`` and ``plot_eval`` write what the JAX writer writes;
- ``run_net`` with TENSORBOARD.MODEL_VIS or WRONG_PRED_VIS visualizes
  after train and test (``tools/visualization.py``).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.visualization.tensorboard_vis import TensorboardWriter as JaxWriter
from pmv_tpu_torch.data.synthetic import Synthetic
from pmv_tpu_torch.engine import train as ptrain
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils import logging as port_logging
from pmv_tpu_torch.visualization.tensorboard_vis import TensorboardWriter
from torch_port_util import port_cfg

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / "configs" / "tiny_synthetic.yaml")


def _scalars(log_dir):
    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def _cfg(out, *opts):
    cfg = jax_get_cfg()
    cfg.merge_from_file(TINY)
    cfg.merge_from_list(["OUTPUT_DIR", str(out), "TENSORBOARD.ENABLE", "True", *opts])
    return cfg


def test_add_video_writes_what_the_jax_writer_writes(tmp_path):
    video = np.random.default_rng(0).integers(0, 256, (2, 3, 8, 8, 3), np.uint8)
    tags = []
    for name, writer_cls, to_cfg in (("jax", JaxWriter, lambda c: c),
                                     ("port", TensorboardWriter, port_cfg)):
        writer = writer_cls(to_cfg(_cfg(tmp_path / name)))
        writer.add_video(video, tag="mae_reconstruction", global_step=1)
        writer.close()
        acc = EventAccumulator(str(tmp_path / name / "runs-synthetic"))
        acc.Reload()
        tags.append(acc.Tags())
    assert tags[0] == tags[1]


@pytest.mark.parametrize("log_dir", ["", "tb"])
def test_writer_writes_what_the_jax_writer_writes(tmp_path, log_dir):
    calls = [({"Val/Top1_err": 62.5, "Val/Top5_err": 12.25}, 0),
             ({"Val/Top1_err": 50.0, "Val/Top5_err": 0.0}, 1)]
    dirs = []
    for name, writer_cls, to_cfg in (("jax", JaxWriter, lambda c: c),
                                     ("port", TensorboardWriter, port_cfg)):
        cfg = to_cfg(_cfg(tmp_path / name, "TENSORBOARD.LOG_DIR", log_dir))
        writer = writer_cls(cfg)
        for scalars, step in calls:
            writer.add_scalars(scalars, global_step=step)
        writer.close()
        dirs.append(tmp_path / name / (log_dir or "runs-synthetic"))
    jax_events, port_events = (_scalars(d) for d in dirs)
    assert port_events == jax_events
    assert port_events["Val/Top1_err"] == [(0, 62.5), (1, 50.0)]


def test_train_writes_the_validation_errors_of_each_epoch(tmp_path):
    cfg = port_cfg(_cfg(tmp_path, "SOLVER.MAX_EPOCH", "2"))
    ptrain.train(cfg, device="cpu")
    events = _scalars(tmp_path / "runs-synthetic")
    assert set(events) == {"Val/Top1_err", "Val/Top5_err"}
    lines = (tmp_path / "stdout.log").read_text().splitlines()
    val = [json.loads(line.split("json_stats: ", 1)[1]) for line in lines
           if '"_type": "val_epoch"' in line]
    for tag, key in (("Val/Top1_err", "top1_err"), ("Val/Top5_err", "top5_err")):
        assert [step for step, _ in events[tag]] == [0, 1]
        for (_, value), stats in zip(events[tag], val):
            assert value == pytest.approx(stats[key], abs=1e-5)


def test_only_rank_0_writes(tmp_path, monkeypatch):
    monkeypatch.setattr(port_logging, "is_master_process", lambda: False)
    ptrain.train(port_cfg(_cfg(tmp_path)), device="cpu")
    assert not (tmp_path / "runs-synthetic").exists()


def test_writer_plots_what_the_jax_writer_plots(tmp_path):
    """``add_histogram`` and ``plot_eval`` (the confusion matrix and the
    top-k histograms) write the JAX writer's events: the same tags,
    histogram buckets and encoded images."""
    rng = np.random.default_rng(1)
    values = rng.normal(size=(6, 5)).astype(np.float32)
    preds = rng.uniform(size=(10, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 10)
    events = []
    for name, writer_cls, to_cfg in (("jax", JaxWriter, lambda c: c),
                                     ("port", TensorboardWriter, port_cfg)):
        cfg = to_cfg(_cfg(tmp_path / name, "MODEL.NUM_CLASSES", "5",
                          "TENSORBOARD.CONFUSION_MATRIX.ENABLE", "True",
                          "TENSORBOARD.HISTOGRAM.ENABLE", "True"))
        writer = writer_cls(cfg)
        writer.add_histogram("weights/w", values if name == "jax" else torch.from_numpy(values.T),
                             global_step=0)
        writer.plot_eval(preds, labels, global_step=0)
        writer.close()
        acc = EventAccumulator(str(tmp_path / name / "runs-synthetic"),
                               size_guidance={"images": 0, "histograms": 0})
        acc.Reload()
        h = acc.Histograms("weights/w")[0].histogram_value
        events.append(({tag: acc.Images(tag)[0].encoded_image_string
                        for tag in acc.Tags()["images"]},
                       (h.min, h.max, h.num, list(h.bucket_limit), list(h.bucket))))
    assert len(events[0][0]) == 6  # the confusion matrix and 5 classes' histograms
    assert events[0] == events[1]


def _tags(log_dir):
    acc = EventAccumulator(str(log_dir), size_guidance={"histograms": 0})
    acc.Reload()
    return acc.Tags()


@pytest.mark.parametrize("key", ["TENSORBOARD.MODEL_VIS.ENABLE",
                                 "TENSORBOARD.WRONG_PRED_VIS.ENABLE"])
def test_run_net_runs_model_and_wrong_prediction_visualization(tmp_path, monkeypatch, key):
    """``run_net`` visualizes (``tools/visualization.py``), after train and
    test where they run (on 16 Synthetic videos here): with MODEL_VIS the
    weight histograms of the trained checkpoint and the input video, with
    WRONG_PRED_VIS alone Grad-CAM, the input video and the misclassified
    clips' videos (recorded here: moviepy, which encodes them, is absent)."""
    monkeypatch.setattr(Synthetic, "NUM_VIDEOS", 16)
    videos = []
    monkeypatch.setattr(TensorboardWriter, "add_video",
                        lambda self, video, tag="", global_step=None, fps=4:
                        videos.append((tag, np.asarray(video).shape)))
    model_vis = key == "TENSORBOARD.MODEL_VIS.ENABLE"
    extra = (["TENSORBOARD.MODEL_VIS.MODEL_WEIGHTS", "True",
              "TENSORBOARD.MODEL_VIS.INPUT_VIDEO", "True"] if model_vis
             else ["TRAIN.ENABLE", "False", "TEST.ENABLE", "False"])
    assert run_net.main(["--cfg", TINY, "--device", "cpu", "--opts", "OUTPUT_DIR",
                         str(tmp_path), "TENSORBOARD.ENABLE", "True", key, "True", *extra]) == 0
    assert cu.has_checkpoint(str(tmp_path)) == model_vis
    tags = _tags(tmp_path / "runs-synthetic")
    weights = [t for t in tags["histograms"] if t.startswith("weights/")]
    if model_vis:
        assert "weights/head.projection.weight" in weights and len(weights) > 20
        assert {"Val/Top1_err", "Val/Top5_err"} <= set(tags["scalars"])
        assert "Load test checkpoint" in (tmp_path / "stdout.log").read_text()
    else:
        assert not weights
        assert any(tag == "Incorrectly classified videos." for tag, _ in videos)
    assert videos[0] == ("Input", (8, 2, 16, 16, 3))
