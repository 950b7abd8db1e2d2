"""The port's train(), test() and run_net on the CPU against the JAX package.

On ``configs/tiny_synthetic.yaml`` (MViT of depth 1 and width 8, 2 frames of
16^2, the Synthetic dataset), float32 (TRAIN.MIXED_PRECISION False:
PyTorch's CPU bfloat16 grouped conv3d weight gradient returns non-finite
values now and then, ROADMAP.md):

- ``test()`` of both packages from one ``.pyth`` written from JAX
  parameters (TEST.CHECKPOINT_FILE_PATH; JAX reads it through its torch
  importer): the TEST.SAVE_RESULTS_PATH video scores to atol 1e-5, the same
  labels, and the same test_final stats;
- ``run_net --device cpu`` trains an epoch, checkpoints, evaluates and
  tests; run again with SOLVER.MAX_EPOCH 2 it resumes at epoch 2 from the
  saved weights; without ``--device cpu`` on a machine without CUDA, it
  raises;
- what the port leaves out raises NotImplementedError.
"""

import json
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine import test as jtest
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu_torch.engine import test as ptest
from pmv_tpu_torch.engine import train as ptrain
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_util import numpy_tree, port_cfg, random_params

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / "configs" / "tiny_synthetic.yaml")


def _tiny_cfg(out):
    cfg = jax_get_cfg()
    cfg.merge_from_file(TINY)
    cfg.TRAIN.MIXED_PRECISION = False
    cfg.OUTPUT_DIR = str(out)
    return cfg


def test_test_matches_jax_from_the_same_weights(tmp_path):
    cfg = _tiny_cfg(tmp_path / "jax")
    cfg.TRAIN.ENABLE = False
    cfg.TEST.SAVE_RESULTS_PATH = "preds.pkl"
    cfg.TEST.PROCESS = True
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    state, _ = jsteps.init_state(
        cfg, jmodel,
        {"frames": jnp.zeros((1, 2, 16, 16, 3), jnp.uint8), "labels": jnp.zeros(1, jnp.int32)},
        jax.random.PRNGKey(0))
    weights = tmp_path / "weights.pyth"
    torch.save({"epoch": 0,
                "model_state": state_dict_from_jax(random_params(numpy_tree(state.params), 2))},
               weights)
    cfg.TEST.PROCESS = False
    cfg.TEST.CHECKPOINT_FILE_PATH = str(weights)
    jstats = jtest.test(cfg)

    pcfg = port_cfg(cfg)
    pcfg.OUTPUT_DIR = str(tmp_path / "port")
    stats = ptest.test(pcfg, device="cpu")

    with open(tmp_path / "jax" / "preds.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "port" / "preds.pkl", "rb") as f:
        got = pickle.load(f)
    assert got["video_preds"].shape == (64, cfg.MODEL.NUM_CLASSES)
    np.testing.assert_allclose(got["video_preds"], want["video_preds"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["video_labels"], want["video_labels"])
    assert stats == jstats


def _json_stats(log):
    return [json.loads(line.split("json_stats: ", 1)[1])
            for line in log.read_text().splitlines() if "json_stats: " in line]


def test_run_net_trains_checkpoints_resumes_and_tests_on_cpu(tmp_path):
    out = tmp_path / "job"
    opts = ["OUTPUT_DIR", str(out), "TRAIN.MIXED_PRECISION", "False"]
    assert run_net.main(["--cfg", TINY, "--device", "cpu", "--opts", *opts]) == 0
    ckpt = out / "checkpoints" / "checkpoint_epoch_00001.pyth"
    assert ckpt.exists()
    kinds = [s.get("_type", s.get("split")) for s in _json_stats(out / "stdout.log")]
    assert [k for k in kinds if not k.endswith("_iter")] == [
        "train_epoch", "val_epoch", "test_final"]
    first = torch.load(ckpt, weights_only=True)
    assert first["epoch"] == 0 and first["optimizer_state"]["param_groups"][0]["count"] == 8

    assert run_net.main(
        ["--cfg", TINY, "--device", "cpu", "--opts", *opts, "SOLVER.MAX_EPOCH", "2"]) == 0
    log = (out / "stdout.log").read_text()
    assert "Load from last checkpoint" in log and "Start epoch: 2" in log
    second = torch.load(out / "checkpoints" / "checkpoint_epoch_00002.pyth", weights_only=True)
    assert second["epoch"] == 1 and second["optimizer_state"]["param_groups"][0]["count"] == 16
    # The log holds both runs: epoch 1 was not trained again.
    epochs = [s["epoch"] for s in _json_stats(out / "stdout.log") if s.get("_type") == "train_epoch"]
    assert epochs == ["1/1", "2/2"]
    assert _json_stats(out / "stdout.log")[-1]["split"] == "test_final"


def test_run_net_refuses_without_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_net.main(["--cfg", TINY, "--opts", "OUTPUT_DIR", str(tmp_path)])
    cfg = port_cfg(_tiny_cfg(tmp_path))
    for entry in (ptrain.train, ptest.test):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(cfg)


UNPORTED = {
    # The model and wrong-prediction visualization run since they were ported
    # (tests/test_torch_port_tensorboard.py, tests/test_torch_port_visualization.py).
    # Detection is ported; its precise BN is not (the JAX package's packs no boxes).
    "detection": ("DETECTION.ENABLE", True, "BN.USE_PRECISE_STATS", True),
    # SSL trains over several processes under dp or fsdp, not dp_sp.
    "ssl": ("MODEL.MODEL_NAME", "ContrastiveModel", "NUM_GPUS", "2", "TPU.SHARD_STRATEGY",
            "dp_sp"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_options_raise(tmp_path, case):
    opts = [str(v) for v in UNPORTED[case]]
    with pytest.raises(NotImplementedError):
        run_net.main(["--cfg", TINY, "--device", "cpu", "--opts", "OUTPUT_DIR",
                      str(tmp_path), *opts])
    assert not cu.has_checkpoint(str(tmp_path))


def test_feature_extraction_matches_jax(tmp_path):
    """TEST.FEAT_EXTRACT: test() writes the pooled features of every test
    clip, and the feature step equals JAX's ``make_feat_step`` (atol 1e-5)."""
    cfg = _tiny_cfg(tmp_path)
    cfg.TEST.PROCESS = True
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    frames = np.random.default_rng(3).integers(0, 256, (3, 2, 16, 16, 3), np.uint8)
    state, _ = jsteps.init_state(
        cfg, jmodel, {"frames": jnp.asarray(frames), "labels": jnp.zeros(3, jnp.int32)},
        jax.random.PRNGKey(0))
    params = random_params(numpy_tree(state.params), 4)
    want = np.asarray(jax.jit(jsteps.make_feat_step(cfg, jmodel))(
        state.replace(params=params), jnp.asarray(frames)))

    weights = tmp_path / "weights.pyth"
    torch.save({"epoch": 0, "model_state": state_dict_from_jax(params)}, weights)
    pcfg = port_cfg(cfg)
    pcfg.TEST.FEAT_EXTRACT = True
    pcfg.TEST.CHECKPOINT_FILE_PATH = str(weights)
    out = ptest.test(pcfg, device="cpu")
    assert out["features"].shape == (128, cfg.MVIT.EMBED_DIM)
    saved = np.load(tmp_path / "features.npz")
    np.testing.assert_array_equal(saved["index"], np.arange(128))

    from pmv_tpu_torch.engine.steps import make_feat_step
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.utils.weights import load_jax_params

    model = load_jax_params(build_model(pcfg, device="cpu", dtype=torch.float32), params)
    got = make_feat_step(pcfg, model, device="cpu")(frames).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_dense_spatial_crop_sweep(tmp_path):
    """TEST.DENSE_SPATIAL_CROP: one pass per point of the ratio grid, each
    saving its results under its ratio's tag (`test_net.py:358-379`)."""
    cfg = port_cfg(_tiny_cfg(tmp_path))
    cfg.TEST.DENSE_SPATIAL_CROP = True
    cfg.TEST.DENSE_SPATIAL_CROP_STEPS = 2
    cfg.TEST.SAVE_RESULTS_PATH = "preds.pkl"
    stats = ptest.test(cfg, device="cpu")
    assert len(stats) == 4 and all(s["split"] == "test_final" for s in stats)
    for tag in ("_r0.00x0.00", "_r0.00x1.00", "_r1.00x0.00", "_r1.00x1.00"):
        assert (tmp_path / f"preds.pkl{tag}").exists()


@pytest.mark.parametrize("opts, views", [
    (["TEST.NUM_ENSEMBLE_VIEWS", "-1"], [1, 3, 5, 7, 10]),
    (["TEST.NUM_TEMPORAL_CLIPS", "[2,4]"], [2, 4]),
])
def test_run_net_view_sweeps(tmp_path, monkeypatch, opts, views):
    """NUM_ENSEMBLE_VIEWS -1 and NUM_TEMPORAL_CLIPS sweep the test's views
    (`run_net.py:30-41`, `test_net.py:400-401`)."""
    seen = []
    monkeypatch.setattr(ptest, "test", lambda cfg, device=None: seen.append(
        (cfg.TEST.NUM_ENSEMBLE_VIEWS, list(cfg.TEST.NUM_TEMPORAL_CLIPS))))
    run_net.main(["--cfg", TINY, "--device", "cpu", "--opts", "OUTPUT_DIR", str(tmp_path),
                  "TRAIN.ENABLE", "False", *opts])
    assert seen == [(v, []) for v in views]
