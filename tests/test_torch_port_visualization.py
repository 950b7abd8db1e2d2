"""The port's visualization and demos against the JAX package's, on the CPU.

- ``gradcam`` (one forward, the gradient taken at the ``features`` tap)
  against `pmv_tpu.visualization.gradcam.gradcam` on tiny UniFormer and
  X3D (grid features; MViT's token features through ``visualize``), from
  the same parameters
  and inputs: maps to atol 1e-5, scores to atol 2e-4 / rtol 1e-4; a model
  without the tap raises;
- ``overlay_heatmap``, ``VideoVisualizer``'s clips (top-k and thres modes,
  boxes, ground truth, slow motion), ``draw_predictions`` and ``draw_boxes``
  equal to JAX's pixel for pixel;
- ``AsyncVis`` returns tasks in put order, drawn alike, with 0 workers and
  with 2 (spawned);
- ``visualize`` against JAX's ``tools/visualization.py::visualize`` on tiny
  MViT over the Synthetic test split: the weight histograms (the port's
  names against JAX's flax paths through ``utils/weights``' map; counts,
  limits, min, max exact), Grad-CAM's maps and scores with the true
  labels, the confusion matrix; and the PREDICTIONS_PATH offline plots;
- ``demo`` end to end on 24- and 25-frame AVIs written by the port's binding
  (BUFFER_SIZE 1, NUM_CLIPS_SKIP 1): each predicted window's scores against
  JAX's, every source frame written once, the frames equal to JAX's;
- ``ava_demo`` with precomputed and ground-truth boxes and SLOWMO 3 on
  tiny Slow R18 detection: each keyframe's box scores against JAX's, the
  frames out equal to JAX's.
"""

import logging
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import port_cfg, tensorboard_without_tensorflow

tensorboard_without_tensorflow()  # before anything imports tensorboard
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator  # noqa: E402

from pmv_tpu import models as pmv_models  # noqa: E402
from pmv_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from pmv_tpu.engine import steps as jsteps  # noqa: E402
from pmv_tpu.models import build_model as jax_build_model  # noqa: E402
from pmv_tpu.utils import logging as jlogging  # noqa: E402
from pmv_tpu.visualization import ava_demo as java_demo
from pmv_tpu.visualization import demo as jdemo
from pmv_tpu.visualization import gradcam as jgradcam
from pmv_tpu.visualization import tensorboard_vis as jtb
from pmv_tpu.visualization import video_vis as jvideo_vis
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.native import binding
from pmv_tpu_torch.tools import visualization as pvis
from pmv_tpu_torch.utils.weights import flax_path_to_torch, load_jax_params, state_dict_from_jax
from pmv_tpu_torch.visualization import ava_demo as pava_demo
from pmv_tpu_torch.visualization import demo as pdemo
from pmv_tpu_torch.visualization import gradcam as pgradcam
from pmv_tpu_torch.visualization import tensorboard_vis as ptb
from pmv_tpu_torch.visualization import video_vis as pvideo_vis
from pmv_tpu_torch.visualization.async_vis import AsyncVis, TaskInfo
from test_torch_port_uniformer import tiny_cfg as tiny_uniformer_cfg
from test_torch_port_x3d import tiny_x3d_cfg
from tools import visualization as jvis

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / "configs" / "tiny_synthetic.yaml")
TINY_SLOWFAST = str(ROOT / "configs" / "tiny_slowfast_synthetic.yaml")
SCORES = dict(atol=2e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _jax_logging_as_it_was():
    """JAX's ``setup_logging`` configures its logger once a process, and
    makes OUTPUT_DIR only then: the JAX entry points called here leave it as
    they found it, for the tests that run after them in the same process."""
    logger = logging.getLogger("pmv_tpu")
    before = (logger.handlers[:], logger.level, logger.propagate, jlogging._LOGGER_CONFIGURED)
    yield
    for handler in logger.handlers:
        if handler not in before[0]:
            handler.close()
    logger.handlers[:] = before[0]
    logger.setLevel(before[1])
    logger.propagate = before[2]
    jlogging._LOGGER_CONFIGURED = before[3]


def _f32(cfg):
    cfg.TRAIN.MIXED_PRECISION = False
    return cfg


def _init_values(shapes, seed=None):
    """Variables of flax's shapes ``shapes`` (``jax.eval_shape`` of an
    init): BatchNorm means 0 and variances 1, as flax's init makes them, and
    the parameters redrawn from ``seed`` (zeros without one: a checkpoint
    then fills every one)."""
    rng = np.random.default_rng(seed)

    def value(path, leaf):
        name = str(path[-1].key)
        if str(path[0].key) != "params":
            return np.full(leaf.shape, 1.0 if name == "var" else 0.0, np.float32)
        if seed is None:
            return np.zeros(leaf.shape, np.float32)
        noise = rng.normal(size=leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * noise if name == "scale" else 0.3 * noise

    return jax.tree_util.tree_map_with_path(value, shapes)


class Jitted:
    """A flax module whose ``apply`` is jitted once (static keyword options)
    and whose ``init`` takes the shapes alone (``jax.eval_shape``): the
    visualization's and the demos' JAX calls are un-jitted, and JAX's eager
    dispatch compiles every primitive alone on the CPU; the tests' models
    load every parameter from a checkpoint, so only the shapes and the
    statistics' init matter."""

    def __init__(self, module):
        self.module = module
        self._apply = jax.jit(module.apply,
                              static_argnames=("train", "mutable", "return_features"))

    def init(self, rng, *args, **kwargs):
        shapes = jax.eval_shape(lambda key: self.module.init(key, *args, **kwargs), rng)
        return dict(_init_values(shapes))

    def apply(self, variables, *args, **kwargs):
        if isinstance(kwargs.get("mutable"), list):
            kwargs["mutable"] = tuple(kwargs["mutable"])
        return self._apply(variables, *args, **kwargs)


def _jitted_build(cfg, *args, **kwargs):
    return Jitted(jax_build_model(cfg, *args, **kwargs))


def _init(cfg, shape, seed, **kwargs):
    """The jitted JAX model of ``cfg`` and its variables at a batch of
    ``shape``: every parameter drawn from ``seed``, the BatchNorm
    statistics at their init (a torch checkpoint reaches JAX's parameters
    alone)."""
    jmodel = _jitted_build(cfg, dtype=jnp.float32)
    inputs = jsteps.pack_pathways(cfg, jnp.zeros(shape, jnp.float32))
    x = inputs[0] if len(inputs) == 1 else inputs
    shapes = jax.eval_shape(lambda key: jmodel.module.init(key, x, train=False, **kwargs),
                            jax.random.PRNGKey(0))
    return jmodel, dict(_init_values(shapes, seed))


def _checkpoint(path, variables):
    torch.save({"epoch": 0, "model_state": state_dict_from_jax(variables)}, path)
    return str(path)


# ---------------------------------------------------------------- Grad-CAM

# MViT's token features are held through ``visualize`` below.
GRADCAM_CFGS = {
    "uniformer": lambda: _f32(tiny_uniformer_cfg()),
    "x3d": lambda: _f32(tiny_x3d_cfg()),
}


@pytest.mark.parametrize("name", sorted(GRADCAM_CFGS))
def test_gradcam_matches_jax(name):
    cfg = GRADCAM_CFGS[name]()
    size = cfg.DATA.TEST_CROP_SIZE
    shape = (2, cfg.DATA.NUM_FRAMES, size, size, 3)
    jmodel, variables = _init(cfg, shape, seed=3)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want_maps, want_preds = jgradcam.gradcam(jmodel, variables, jnp.asarray(x))

    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    load_jax_params(model, variables)
    maps, preds = pgradcam.gradcam(model, torch.from_numpy(x))
    assert maps.shape == want_maps.shape and maps.shape[0] == 2
    assert float(maps.min()) >= 0.0 and float(maps.max()) <= 1.0
    np.testing.assert_allclose(preds.numpy(), want_preds, **SCORES)
    np.testing.assert_allclose(maps.numpy(), want_maps, atol=1e-5, rtol=0)
    # The gradient stopped at the tap: no parameter took one, and each
    # parameter needs one again, as before.
    assert all(p.grad is None and p.requires_grad for p in model.parameters())
    # With given labels: JAX's target_labels.
    labels = np.array([1, 0])
    want_maps, _ = jgradcam.gradcam(jmodel, variables, jnp.asarray(x), jnp.asarray(labels))
    maps, _ = pgradcam.gradcam(model, torch.from_numpy(x), labels)
    np.testing.assert_allclose(maps.numpy(), want_maps, atol=1e-5, rtol=0)


def test_gradcam_refuses_a_model_without_its_tap():
    cfg = jax_get_cfg()
    cfg.merge_from_file(TINY_SLOWFAST)
    model = build_model(port_cfg(cfg), device="cpu")
    with pytest.raises(ValueError, match="no Grad-CAM tap"):
        pgradcam.gradcam(model, torch.zeros(1, 4, 32, 32, 3))


# ------------------------------------------------------------- the drawing

def test_overlays_and_video_visualizer_frames_match_jax():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (6, 40, 56, 3), np.uint8)
    cam = rng.uniform(size=(5, 7)).astype(np.float32)
    np.testing.assert_array_equal(pgradcam.overlay_heatmap(frames[0], cam),
                                  jgradcam.overlay_heatmap(frames[0], cam))
    preds = rng.uniform(size=(7,)).astype(np.float32)
    boxes = np.array([[2.0, 3.0, 30.0, 35.0], [20.0, 5.0, 50.0, 38.0]], np.float32)
    box_preds = rng.uniform(size=(2, 7)).astype(np.float32)
    labels = [[(1, "one", 0.9), (4, "four", 0.25)], [(6, "six", 0.5)]]
    np.testing.assert_array_equal(pvideo_vis.draw_predictions(frames[1], preds, list("abcdefg")),
                                  jvideo_vis.draw_predictions(frames[1], preds, list("abcdefg")))
    np.testing.assert_array_equal(pvideo_vis.draw_boxes(frames[2], boxes, labels, 7),
                                  jvideo_vis.draw_boxes(frames[2], boxes, labels, 7))
    for kwargs, call in (
        (dict(mode="top-k", top_k=3), dict(preds=preds)),
        (dict(mode="thres", thres=0.6, lower_thres=0.2),
         dict(preds=box_preds, bboxes=boxes, repeat_frame=2, draw_range=[1, 4])),
        (dict(mode="top-k"), dict(preds=[[1, 2], [5]], bboxes=boxes, ground_truth=True)),
    ):
        got = pvideo_vis.VideoVisualizer(7, **kwargs).draw_clip_range(frames, **call)
        want = jvideo_vis.VideoVisualizer(7, **kwargs).draw_clip_range(frames, **call)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _tasks(n, seed=0):
    rng = np.random.default_rng(seed)
    tasks = []
    for i in range(n):
        task = TaskInfo(num_buffer_frames=1 if i else 0, img_height=24, img_width=32,
                        crop_size=16, clip_vis_size=2)
        task.add_frames(i, rng.integers(0, 256, (5, 24, 32, 3), np.uint8))
        if i % 3 != 2:  # every third passes through unannotated
            task.action_preds = rng.uniform(size=(5,)).astype(np.float32)
        tasks.append(task)
    return tasks


@pytest.mark.parametrize("workers", [0, 2])
def test_async_vis_returns_tasks_in_put_order(workers):
    vis = pvideo_vis.VideoVisualizer(5, top_k=2)
    want = [np.array(jvideo_vis.VideoVisualizer(5, top_k=2).draw_clip_range(
        t.frames[t.num_buffer_frames:], t.action_preds,
        keyframe_idx=len(t.frames) // 2 - t.num_buffer_frames,
        draw_range=[len(t.frames) // 2 - t.num_buffer_frames - 2,
                    len(t.frames) // 2 - t.num_buffer_frames + 2]))
        if t.action_preds is not None else t.frames[t.num_buffer_frames:]
        for t in _tasks(6)]
    pool = AsyncVis(vis, n_workers=workers)
    try:
        for task in _tasks(6):
            pool.get_indices_ls.append(task.id)
            pool.put(task)
        got = []
        while len(got) < 6:
            try:
                got.append(pool.get())
            except Exception:  # queue.Empty until the next in put order is drawn
                pass
    finally:
        pool.shutdown()
    assert [t.id for t in got] == list(range(6))
    assert not pool.procs
    for task, frames in zip(got, want):
        np.testing.assert_array_equal(task.frames[task.num_buffer_frames:], frames)


# ------------------------------------------------------------- visualize

def _histograms(log_dir):
    acc = EventAccumulator(str(log_dir), size_guidance={"histograms": 0})
    acc.Reload()
    return {tag: acc.Histograms(tag)[0].histogram_value for tag in acc.Tags()["histograms"]}


def _spy(monkeypatch, module, name, seen):
    original = getattr(module, name)

    def spy(*args, **kwargs):
        out = original(*args, **kwargs)
        seen.append((args, kwargs, out))
        return out

    monkeypatch.setattr(module, name, spy)


def _vis_cfg(out, checkpoint=""):
    cfg = jax_get_cfg()
    cfg.merge_from_file(TINY)
    cfg.merge_from_list([
        "OUTPUT_DIR", str(out), "TRAIN.MIXED_PRECISION", "False", "TEST.BATCH_SIZE", "4",
        "TEST.CHECKPOINT_FILE_PATH", checkpoint,
        "TENSORBOARD.ENABLE", "True", "TENSORBOARD.CONFUSION_MATRIX.ENABLE", "True",
        "TENSORBOARD.HISTOGRAM.ENABLE", "True", "TENSORBOARD.HISTOGRAM.TOPK", "3",
        "TENSORBOARD.MODEL_VIS.ENABLE", "True", "TENSORBOARD.MODEL_VIS.MODEL_WEIGHTS", "True",
        "TENSORBOARD.MODEL_VIS.LAYER_LIST", "['blocks.0/attn', 'head']",
        "TENSORBOARD.MODEL_VIS.GRAD_CAM.USE_TRUE_LABEL", "True",
        "TENSORBOARD.WRONG_PRED_VIS.ENABLE", "True",
    ])
    return cfg


def test_visualize_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(pmv_models, "build_model", _jitted_build)
    cfg = _vis_cfg(tmp_path)
    _, variables = _init(cfg, (2, 2, 16, 16, 3), seed=5)
    checkpoint = _checkpoint(tmp_path / "weights.pyth", variables)
    cams, evals = {"jax": [], "port": []}, {"jax": [], "port": []}
    _spy(monkeypatch, jgradcam, "gradcam", cams["jax"])
    _spy(monkeypatch, pvis, "gradcam", cams["port"])
    _spy(monkeypatch, jtb, "confusion_matrix", evals["jax"])
    _spy(monkeypatch, ptb, "confusion_matrix", evals["port"])
    jvis.visualize(_vis_cfg(tmp_path / "jax", checkpoint))
    pvis.visualize(port_cfg(_vis_cfg(tmp_path / "port", checkpoint)), device="cpu")

    assert len(cams["port"]) == len(cams["jax"]) == 5  # the sweep's bound
    for (_, _, (maps, preds)), (_, _, (want_maps, want_preds)) in zip(cams["port"], cams["jax"]):
        np.testing.assert_allclose(preds.numpy(), want_preds, **SCORES)
        np.testing.assert_allclose(maps.numpy(), want_maps, atol=1e-5, rtol=0)
    (args, _, cmtx), = evals["port"]
    (want_args, _, want_cmtx), = evals["jax"]
    np.testing.assert_array_equal(args[1], want_args[1])  # the labels
    np.testing.assert_array_equal(cmtx, want_cmtx)

    got = _histograms(tmp_path / "port" / "runs-synthetic")
    want = {"weights/" + flax_path_to_torch(tag.split("/")[1:]): h
            for tag, h in _histograms(tmp_path / "jax" / "runs-synthetic").items()}
    assert sorted(got) == sorted(want) and any("head" in t for t in got)
    assert all(t.startswith(("weights/blocks.0.attn.", "weights/head.")) for t in got)
    for tag, h in got.items():
        w = want[tag]
        assert (h.min, h.max, h.num) == (w.min, w.max, w.num), tag
        assert list(h.bucket_limit) == list(w.bucket_limit), tag
        assert list(h.bucket) == list(w.bucket), tag
        assert h.sum == pytest.approx(w.sum, rel=1e-5, abs=1e-5)


def _images(log_dir):
    acc = EventAccumulator(str(log_dir), size_guidance={"images": 0})
    acc.Reload()
    return {tag: acc.Images(tag)[0].encoded_image_string for tag in acc.Tags()["images"]}


def test_visualize_plots_a_predictions_file_as_jax_does(tmp_path):
    rng = np.random.default_rng(2)
    path = tmp_path / "preds.pkl"
    with open(path, "wb") as f:
        pickle.dump({"video_preds": rng.uniform(size=(12, 5)).astype(np.float32),
                     "video_labels": rng.integers(0, 5, 12)}, f)
    images = []
    for name, visualize in (("jax", jvis.visualize),
                            ("port", lambda c: pvis.visualize(port_cfg(c), device="cpu"))):
        cfg = _vis_cfg(tmp_path / name)
        cfg.merge_from_list(["TENSORBOARD.PREDICTIONS_PATH", str(path),
                             "TENSORBOARD.MODEL_VIS.ENABLE", "False",
                             "TENSORBOARD.WRONG_PRED_VIS.ENABLE", "False"])
        visualize(cfg)
        images.append(_images(tmp_path / name / "runs-synthetic"))
    assert sorted(images[0]) == ["Confusion Matrix"] + [f"Histogram/class_{c}" for c in range(5)]
    assert images[0] == images[1]


# ------------------------------------------------------------- the demos

class _Recorded:
    """Each demo's ``AsyncVis``, recording the tasks it is handed."""

    def __init__(self, base):
        self.tasks = []
        recorded = self

        class Recording(base):
            def put(self, task):
                recorded.tasks.append((task.id, None if task.action_preds is None
                                       else np.array(task.action_preds)))
                super().put(task)

        self.cls = Recording


def _read(path):
    with binding.VideoReader(path) as reader:
        return reader.read_frames(np.arange(reader.num_frames))


def _demo_cfg(tmp_path, video, name):
    cfg = _f32(tiny_x3d_cfg("DATA.NUM_FRAMES", "2", "DATA.TEST_CROP_SIZE", "16"))
    cfg.merge_from_list([
        "DATA.SAMPLING_RATE", "2", "DEMO.ENABLE", "True", "DEMO.INPUT_VIDEO", str(video),
        "DEMO.OUTPUT_FILE", str(tmp_path / f"{name}.avi"), "DEMO.BUFFER_SIZE", "1",
        "DEMO.NUM_CLIPS_SKIP", "1", "DEMO.NUM_VIS_INSTANCES", "0",
        "TEST.CHECKPOINT_FILE_PATH", str(tmp_path / "weights.pyth"),
        "OUTPUT_DIR", str(tmp_path / name)])
    return cfg


@pytest.mark.parametrize("frames", [24, 25])
def test_demo_matches_jax(tmp_path, monkeypatch, frames):
    monkeypatch.setattr(jdemo, "build_model", _jitted_build)
    video = tmp_path / "in.avi"
    source = np.random.default_rng(frames).integers(0, 256, (frames, 32, 24, 3), np.uint8)
    binding.write_test_video(video, source, fps=12)
    cfg = _demo_cfg(tmp_path, video, "jax")
    _, variables = _init(cfg, (1, 2, 16, 16, 3), seed=7)
    _checkpoint(tmp_path / "weights.pyth", variables)
    seen = {}
    for name, module, demo, to_cfg in (("jax", jdemo, jdemo.demo, lambda c: c),
                                       ("port", pdemo, lambda c: pdemo.demo(c, device="cpu"),
                                        port_cfg)):
        seen[name] = _Recorded(module.AsyncVis)
        monkeypatch.setattr(module, "AsyncVis", seen[name].cls)
        demo(to_cfg(_demo_cfg(tmp_path, video, name)))

    windows = -(-frames // 4)
    got, want = seen["port"].tasks, seen["jax"].tasks
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(windows))
    for (i, preds), (_, want_preds) in zip(got, want):
        assert (preds is None) == (want_preds is None) == (i % 2 == 1)
        if preds is not None:
            np.testing.assert_allclose(preds, want_preds, **SCORES)
    out = _read(tmp_path / "port.avi")
    assert len(out) == frames
    np.testing.assert_array_equal(out, _read(tmp_path / "jax.avi"))


def _ava_cfg(tmp_path, video, name):
    cfg = _f32(jax_get_cfg())
    cfg.merge_from_list([
        "MODEL.MODEL_NAME", "ResNet", "MODEL.ARCH", "slow", "MODEL.NUM_CLASSES", "5",
        "MODEL.HEAD_ACT", "sigmoid", "RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8",
        "DETECTION.ENABLE", "True", "DETECTION.SPATIAL_SCALE_FACTOR", "16",
        "DETECTION.ROI_XFORM_RESOLUTION", "4", "DATA.NUM_FRAMES", "4",
        "DATA.SAMPLING_RATE", "2", "DATA.TEST_CROP_SIZE", "32", "DEMO.ENABLE", "True",
        "DEMO.INPUT_VIDEO", str(video), "DEMO.PREDS_BOXES", str(tmp_path / "preds.csv"),
        "DEMO.STARTING_SECOND", "900", "DEMO.OUTPUT_FILE", str(tmp_path / f"{name}.avi"),
        "TEST.CHECKPOINT_FILE_PATH", str(tmp_path / "weights.pyth"),
        "DEMO.GT_BOXES", str(tmp_path / "gt.csv"), "DEMO.SLOWMO", "3",
        "OUTPUT_DIR", str(tmp_path / name)])
    return cfg


def test_ava_demo_with_ground_truth_and_slow_motion_matches_jax(tmp_path, monkeypatch):
    """Keyframes 901 and 903 hold predicted boxes, 901 and 902 ground-truth
    ones: the prediction-only, the merged and the ground-truth-only
    keyframes, each drawn SLOWMO 3 times slower within its draw range."""
    monkeypatch.setattr(java_demo, "build_model", _jitted_build)
    video = tmp_path / "kf_video.avi"
    source = np.random.default_rng(1).integers(0, 256, (40, 32, 48, 3), np.uint8)
    binding.write_test_video(video, source, fps=10)
    (tmp_path / "preds.csv").write_text(
        "kf_video,901,0.1,0.1,0.6,0.8,1,0.99\n"
        "kf_video,901,0.5,0.2,0.9,0.9,2,0.95\n"
        "kf_video,903,0.2,0.2,0.7,0.7,1,0.98\n")
    (tmp_path / "gt.csv").write_text(
        "kf_video,901,0.15,0.1,0.65,0.8,2\n"
        "kf_video,902,0.2,0.2,0.8,0.8,3\n")
    cfg = _ava_cfg(tmp_path, video, "jax")
    _, variables = _init(cfg, (1, 4, 32, 32, 3), seed=9,
                         boxes=jnp.zeros((1, 16, 4), jnp.float32),
                         box_mask=jnp.zeros((1, 16), bool))
    _checkpoint(tmp_path / "weights.pyth", variables)
    merged = {"jax": [], "port": []}
    _spy(monkeypatch, java_demo, "merge_pred_gt_boxes", merged["jax"])
    _spy(monkeypatch, pava_demo, "merge_pred_gt_boxes", merged["port"])
    java_demo.ava_demo(_ava_cfg(tmp_path, video, "jax"))
    pava_demo.ava_demo(port_cfg(_ava_cfg(tmp_path, video, "port")), device="cpu")

    (_, _, got), = merged["port"]
    (_, _, want), = merged["jax"]
    assert sorted(got) == sorted(want) == [10, 20, 30]
    for kf in got:
        assert len(got[kf]) == len(want[kf])
        for (is_gt, boxes, labels), (want_gt, want_boxes, want_labels) in zip(got[kf], want[kf]):
            assert is_gt == want_gt
            np.testing.assert_array_equal(np.asarray(boxes), np.asarray(want_boxes))
            if is_gt:
                assert labels == want_labels
            else:
                np.testing.assert_allclose(labels, want_labels, **SCORES)
    out = _read(tmp_path / "port.avi")
    assert len(out) > 40  # every source frame, the draw ranges slowed down
    np.testing.assert_array_equal(out, _read(tmp_path / "jax.avi"))


@pytest.mark.parametrize("which", ["demo", "ava_demo"])
def test_run_net_dispatches_the_demos(tmp_path, which):
    """DEMO.ENABLE through ``run_net`` (`tools/run_net.py:79-88`): the AVA demo
    with DETECTION.ENABLE and DEMO.PREDS_BOXES, else the demo; every source
    frame written once."""
    from pmv_tpu_torch.tools import run_net

    video = tmp_path / "kf_video.avi"
    binding.write_test_video(video, np.random.default_rng(3).integers(
        0, 256, (20, 32, 48, 3), np.uint8), fps=10)
    out = tmp_path / "out.avi"
    opts = ["TRAIN.ENABLE", "False", "TEST.ENABLE", "False", "DEMO.ENABLE", "True",
            "DEMO.INPUT_VIDEO", str(video), "DEMO.OUTPUT_FILE", str(out),
            "DEMO.NUM_VIS_INSTANCES", "0", "OUTPUT_DIR", str(tmp_path / "job")]
    if which == "ava_demo":
        (tmp_path / "preds.csv").write_text("kf_video,901,0.1,0.1,0.6,0.8,1,0.99\n")
        cfg = _ava_cfg(tmp_path, video, "job")
        cfg.merge_from_list(["DEMO.GT_BOXES", "", "DEMO.SLOWMO", "1"])
        path = tmp_path / "run.yaml"
        path.write_text(cfg.dump())
        argv = ["--cfg", str(path)]
    else:
        argv = ["--cfg", TINY]
    assert run_net.main([*argv, "--device", "cpu", "--opts", *opts,
                         "TEST.CHECKPOINT_FILE_PATH", ""]) == 0
    assert len(_read(out)) == 20
