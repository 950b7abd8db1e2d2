"""The port's frame-list datasets (SSv2, Sth, Charades, ImageNet) against the
JAX package's, and the multi-label path end to end on a tiny Charades.

Each test writes its own frame dump in ``tmp_path``: JPEG frames of noise
from a numpy seed (decoded by PIL on both sides), the frame lists, label
files and JSON the datasets read. Both packages build each dataset from one
config:

- ``len``, the labels (Charades': the per-frame lists), ``_seq_frames`` and
  ``_sample_and_pack`` equal, each side handed a generator of one seed;
  a whole train sample equal with the JAX package's unseeded generator
  replaced by the port's (RNG_SEED, epoch, index) one; test-mode samples
  (which draw nothing) equal exactly; Charades' label vector is the union
  of the sampled frames' labels;
- a clip's JPEGs decoded into one float32 array, PIL's pixels, and a
  frame of another size refused;
- the multigrid short cycle's (index, phase) index raises on both sides,
  and through the port's short-cycle loader; Sth at the default
  DATA.LABEL_PATH_TEMPLATE raises IndexError on both sides;
- ``run_net --device cpu`` on a tiny Charades (X3D, bce_logit, sigmoid, as
  tests/test_frame_datasets.py's JAX run): one epoch, a finite loss, the
  eval epoch's mAP and a test_final mAP;
- ``test()`` of both packages on the tiny Charades from one ``.pyth`` of JAX
  parameters, 2 views, ENSEMBLE_METHOD max: per-video scores and mAP to
  atol 1e-5.
"""

import json
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pmv_tpu.data  # noqa: F401  (registration)
from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.data import frame_datasets as jfd
from pmv_tpu.data.build import build_dataset as jax_build_dataset
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine import test as jtest
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu_torch.data import frame_datasets as pfd
from pmv_tpu_torch.data.build import build_dataset
from pmv_tpu_torch.data.loader import DataLoader
from pmv_tpu_torch.engine import test as ptest
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_util import numpy_tree, one_thread, port_cfg, random_params  # noqa: F401

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

CLASSES = 5
# A tiny X3D, as tests/test_frame_datasets.py's JAX run on Charades takes.
TINY_X3D = str(Path(__file__).resolve().parents[1] / "configs" / "tiny_x3d_synthetic.yaml")
MULTI_LABEL = ("MODEL.NUM_CLASSES", str(CLASSES), "MODEL.LOSS_FUNC", "bce_logit",
               "MODEL.HEAD_ACT", "sigmoid", "DATA.MULTI_LABEL", "True",
               "DATA.ENSEMBLE_METHOD", "max")


def _write_video(root, name, n, rng, size=(32, 24)):
    """``n`` JPEG frames of noise under root/name; their paths relative to
    root."""
    (root / name).mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), np.uint8)).save(
            root / name / f"{i:05d}.jpg")
        paths.append(f"{name}/{i:05d}.jpg")
    return paths


def _frame_list(paths_by_video, labels):
    """A frame list: the header, then a row a frame; ``labels(v, j)`` the
    quoted label list of frame j of video v."""
    rows = ["original_vido_id video_id frame_id path labels"]
    for v, (name, paths) in enumerate(paths_by_video.items()):
        rows += [f'{name} {v} {j} {p} "{labels(v, j)}"' for j, p in enumerate(paths)]
    return "\n".join(rows) + "\n"


def _charades(root, videos=8, frames=12):
    """Charades' train list with labels a frame, its val list with one
    label set a video (the multi-view test holds a video's labels equal
    across its views)."""
    rng = np.random.default_rng(0)
    paths = {f"c{v}": _write_video(root / "frames", f"c{v}", frames, rng) for v in range(videos)}

    def draw():
        return ",".join(map(str, sorted(rng.choice(CLASSES, rng.integers(1, 3), replace=False))))

    per_frame = [[draw() for _ in range(frames)] for _ in range(videos)]
    per_video = [draw() for _ in range(videos)]
    (root / "train.csv").write_text(_frame_list(paths, lambda v, j: per_frame[v][j]))
    (root / "val.csv").write_text(_frame_list(paths, lambda v, j: per_video[v]))
    return ("DATA.PATH_TO_DATA_DIR", str(root), "DATA.PATH_PREFIX", str(root / "frames"),
            "MODEL.NUM_CLASSES", str(CLASSES))


def _ssv2(root):
    rng = np.random.default_rng(1)
    paths = {str(1000 + v): _write_video(root / "frames", str(1000 + v), 10 + v, rng)
             for v in range(4)}
    (root / "something-something-v2-labels.json").write_text(
        json.dumps({"Doing thing 0": "0", "Doing thing 1": "1"}))
    for split, names in (("train", ["1000", "1001", "1003"]), ("validation", ["1001", "1002"])):
        (root / f"something-something-v2-{split}.json").write_text(json.dumps(
            [{"id": n, "template": f"[Doing thing {int(n) % 2}]"} for n in names]))
    for split in ("train", "val"):
        (root / f"{split}.csv").write_text(_frame_list(paths, lambda v, j: ""))
    return ("DATA.PATH_TO_DATA_DIR", str(root), "DATA.PATH_PREFIX", str(root / "frames"))


def _sth(root):
    rng = np.random.default_rng(2)
    rows = []
    for v, n in enumerate((10, 14, 9)):
        _write_video(root / "frames", f"vid{v}", n, rng)
        rows.append(f"vid{v} {n} {v % 3}")
    for split in ("train", "validation"):
        (root / f"somesomev1_rgb_{split}_split.txt").write_text("\n".join(rows) + "\n")
    return ("DATA.PATH_TO_DATA_DIR", str(root), "DATA.PATH_PREFIX", str(root / "frames"),
            "DATA.LABEL_PATH_TEMPLATE", "somesomev1_rgb_{}_split.txt",
            "DATA.IMAGE_TEMPLATE", "{:05d}.jpg")


def _imagenet(root):
    rng = np.random.default_rng(3)
    (root / "imgs").mkdir(parents=True)
    rows = []
    for i, size in enumerate(((40, 30), (28, 44), (36, 36))):
        Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), np.uint8)).save(
            root / "imgs" / f"{i}.jpg")
        rows.append(f"{i}.jpg {i + 2}")
    for split in ("train", "val"):
        (root / f"{split}.txt").write_text("\n".join(rows) + "\n")
    return ("DATA.PATH_TO_DATA_DIR", str(root), "DATA.PATH_PREFIX", str(root / "imgs"))


DATASETS = {"charades": _charades, "ssv2": _ssv2, "sth": _sth, "imagenet": _imagenet}
COMMON = ("DATA.NUM_FRAMES", "4", "DATA.SAMPLING_RATE", "2", "DATA.TRAIN_CROP_SIZE", "16",
          "DATA.TEST_CROP_SIZE", "16", "DATA.TRAIN_JITTER_SCALES", "[18, 22]",
          "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "3",
          "MODEL.NUM_CLASSES", str(CLASSES), "RNG_SEED", "4")


def _cfg(*opts):
    cfg = jax_get_cfg()
    cfg.merge_from_list(list(COMMON + opts))
    return cfg


def _both(name, cfg, mode):
    return jax_build_dataset(name, cfg, mode), build_dataset(name, port_cfg(cfg), mode)


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def _labels(ds):
    return ds._frame_labels if isinstance(ds, (jfd.Charades, pfd.Charades)) else ds._labels


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_matches_jax(tmp_path, monkeypatch, name, mode):
    cfg = _cfg(*DATASETS[name](tmp_path))
    jds, ds = _both(name, cfg, mode)
    assert len(ds) == len(jds) > 0
    assert _labels(ds) == _labels(jds)
    default_rng = np.random.default_rng
    for index in range(len(ds)):
        if mode == "test":  # no draws: the samples themselves are equal
            _assert_samples_equal(ds[index], jds[index])
            continue
        if name != "imagenet":  # whose JAX class samples in __getitem__ alone
            frames = default_rng(index).uniform(0, 255, (4, 24, 32, 3)).astype(np.float32)
            assert ds._seq_frames(index, default_rng(index)) == \
                jds._seq_frames(index, default_rng(index))
            got = ds._sample_and_pack(frames, index, 1, default_rng(index))
            want = jds._sample_and_pack(frames, index, 1, default_rng(index))
            _assert_samples_equal(got, want)
        # The JAX sample with its unseeded generator taking the port's seed.
        monkeypatch.setattr(np.random, "default_rng", lambda *a: default_rng(
            *(a or [(cfg.RNG_SEED, 0, index)])))
        got, want = ds[index], jds[index]
        monkeypatch.setattr(np.random, "default_rng", default_rng)
        _assert_samples_equal(got, want)
        assert got["frames"].shape == ((1,) if name == "imagenet" else (4,)) + (16, 16, 3)
        if name == "charades":  # the union of the sampled frames' labels
            seq = ds._seq_frames(index, default_rng((cfg.RNG_SEED, 0, index)))
            union = {c for i in seq for c in ds._frame_labels[index][i]}
            assert set(np.flatnonzero(got["label"])) == union


def test_a_clip_decodes_into_one_float32_array_of_pil_pixels(tmp_path):
    """``_load_jpeg_frames`` writes each decoded frame into one float32
    [T, H, W, 3] array: PIL's RGB pixels, in the paths' order (a path may
    repeat, as a short video's clamped window repeats its last frame); a
    frame of another size than the clip's first raises."""
    paths = [str(tmp_path / p) for p in _write_video(tmp_path, "v", 4, np.random.default_rng(5))]
    order = [0, 2, 1, 3, 3]
    got = pfd._load_jpeg_frames([paths[i] for i in order])
    assert got.dtype == np.float32 and got.shape == (5, 24, 32, 3)
    for row, i in zip(got, order):
        np.testing.assert_array_equal(row, np.asarray(Image.open(paths[i]).convert("RGB")))
    other = tmp_path / "other.jpg"
    Image.fromarray(np.zeros((32, 24, 3), np.uint8)).save(other)
    with pytest.raises(ValueError, match="the clip's first frame"):
        pfd._load_jpeg_frames([paths[0], str(other)])


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_the_short_cycle_index_raises_on_both_sides(tmp_path, name):
    """The JAX datasets index their lists with the multigrid loader's
    (index, phase) and fail; the port refuses it."""
    cfg = _cfg(*DATASETS[name](tmp_path))
    jds, ds = _both(name, cfg, "train")
    with pytest.raises((TypeError, IndexError)):
        jds[(0, 0)]
    with pytest.raises(NotImplementedError, match="SHORT_CYCLE"):
        ds[(0, 0)]
    if name == "charades":
        loader = DataLoader(ds, batch_size=1, shuffle=True, drop_last=True, num_workers=1,
                            short_cycle=(2, 1))
        with pytest.raises(NotImplementedError, match="SHORT_CYCLE"):
            next(iter(loader))


def test_sth_at_the_default_label_template_raises_on_both_sides(tmp_path):
    """DATA.LABEL_PATH_TEMPLATE's default "{}{}.csv" takes two fields; Sth
    formats it with one."""
    cfg = _cfg(*_sth(tmp_path)[:4])
    with pytest.raises(IndexError):
        jax_build_dataset("sth", cfg, "train")
    with pytest.raises(IndexError):
        build_dataset("sth", port_cfg(cfg), "train")


def _charades_opts(root, out):
    return [*_charades(root), *MULTI_LABEL,
            "TRAIN.DATASET", "charades", "TEST.DATASET", "charades",
            "DATA.NUM_FRAMES", "4", "DATA.SAMPLING_RATE", "2", "DATA.TRAIN_CROP_SIZE", "16",
            "DATA.TEST_CROP_SIZE", "16", "DATA.TRAIN_JITTER_SCALES", "[18, 22]",
            "TRAIN.BATCH_SIZE", "2", "TEST.BATCH_SIZE", "8", "TEST.NUM_ENSEMBLE_VIEWS", "2",
            "TEST.NUM_SPATIAL_CROPS", "1", "TRAIN.MIXED_PRECISION", "False",
            "DATA_LOADER.NUM_WORKERS", "2", "NUM_GPUS", "1", "OUTPUT_DIR", str(out)]


def _json_stats(log):
    return [json.loads(line.split("json_stats: ", 1)[1])
            for line in log.read_text().splitlines() if "json_stats: " in line]


def test_run_net_trains_evaluates_and_tests_charades_on_cpu(tmp_path, one_thread):  # noqa: F811
    out = tmp_path / "job"
    argv = ["--cfg", TINY_X3D, "--device", "cpu", "--opts",
            *_charades_opts(tmp_path / "data", out),
            "SOLVER.MAX_EPOCH", "1", "TRAIN.EVAL_PERIOD", "1", "BN.USE_PRECISE_STATS", "False"]
    assert run_net.main(argv) == 0
    stats = _json_stats(out / "stdout.log")
    train = [s for s in stats if s.get("_type") == "train_epoch"]
    val = [s for s in stats if s.get("_type") == "val_epoch"]
    assert len(train) == len(val) == 1 and np.isfinite(train[0]["loss"])
    assert 0.0 <= val[0]["map"] <= 1.0
    assert stats[-1]["split"] == "test_final" and 0.0 <= stats[-1]["map"] <= 1.0
    assert (out / "checkpoints" / "checkpoint_epoch_00001.pyth").exists()


@pytest.fixture
def jax_logging_restored(monkeypatch):
    """The JAX package's logging as the test found it: its ``setup_logging``
    configures the "pmv_tpu" logger once a process (and makes OUTPUT_DIR
    only then), so a later test's JAX run in this worker must find it
    unconfigured if it was."""
    import logging

    from pmv_tpu.utils import logging as jlogging

    logger = logging.getLogger("pmv_tpu")
    handlers = list(logger.handlers)
    monkeypatch.setattr(jlogging, "_LOGGER_CONFIGURED", jlogging._LOGGER_CONFIGURED)
    yield
    for handler in logger.handlers[:]:
        if handler not in handlers:
            logger.removeHandler(handler)
            handler.close()


def test_charades_test_matches_jax_from_the_same_weights(tmp_path, one_thread,  # noqa: F811
                                                         jax_logging_restored):
    """Test-mode sampling draws nothing, so both packages score the same
    clips: per-video scores under ENSEMBLE_METHOD max and the mAP (8 videos
    x 2 views in batches of 8: the JAX test shards a batch over the 8 CPU
    devices of tests/conftest.py)."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(TINY_X3D)
    cfg.merge_from_list(_charades_opts(tmp_path / "data", tmp_path / "jax"))
    cfg.TRAIN.ENABLE = False
    cfg.TEST.SAVE_RESULTS_PATH = "preds.pkl"
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    state, _ = jsteps.init_state(
        cfg, jmodel,
        {"frames": jnp.zeros((1, 4, 16, 16, 3), jnp.uint8),
         "labels": jnp.zeros((1, CLASSES), jnp.float32)},
        jax.random.PRNGKey(0))
    # Parameters only: both packages keep the BatchNorm statistics' init.
    weights = tmp_path / "weights.pyth"
    torch.save({"epoch": 0,
                "model_state": state_dict_from_jax(random_params(numpy_tree(state.params), 2))},
               weights)
    cfg.TEST.CHECKPOINT_FILE_PATH = str(weights)
    (tmp_path / "jax").mkdir()
    jstats = jtest.test(cfg)
    pcfg = port_cfg(cfg)
    pcfg.OUTPUT_DIR = str(tmp_path / "port")
    stats = ptest.test(pcfg, device="cpu")
    with open(tmp_path / "jax" / "preds.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "port" / "preds.pkl", "rb") as f:
        got = pickle.load(f)
    assert got["video_preds"].shape == (8, CLASSES)
    np.testing.assert_allclose(got["video_preds"], want["video_preds"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["video_labels"], want["video_labels"])
    assert got["video_labels"].sum(axis=1).min() >= 1
    np.testing.assert_allclose(stats["map"], jstats["map"], atol=1e-5, rtol=0)
