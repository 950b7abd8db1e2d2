"""The port's UniFormer train path against the JAX package's.

At tiny UniFormer width (tests/test_torch_port_uniformer.py's ``tiny_cfg``)
on 64x64 crops (at 32x32 the last stage's BatchNorm sees 4 positions a
channel, and the JAX step's own grad norm moves by 1e-4 with XLA's
optimization level), float32 on the CPU, from the same parameters and
BatchNorm statistics:

- two train steps (RandAugment, erasing, MixUp/CutMix, soft cross-entropy,
  AdamW with clipping; DropPath 0, since flax draws its masks from module
  RNG streams) against the jitted JAX ``make_train_step`` fed the same draws
  (``jax_train_draws``): loss and grad norm to rtol 1e-4, top-1/top-5
  equal, running statistics to atol 2e-4 and rtol 1e-4, parameters to atol
  1e-5 (but
  where the gradient is float noise, ``_assert_state_matches``); also
  under MODEL.FROZEN_BN, where the statistics do not move;
- the portrait (``pm``) train step on a mixed batch of a rect 96x64 crop
  against ``make_train_step(model_pm=...)``: both passes over the whole
  batch, the transposed one leaving the running statistics alone, then the
  select; the per-group split of MViT's step would differ here, because
  BatchNorm's batch statistics cross rows;
- the ``pm`` eval step against ``_make_pm_eval_step``, and
  ``make_feat_step`` (the mean of the feature grid) against JAX's;
- ``run_net --device cpu`` on configs/Kinetics/UNIFORMER_S_16x4.yaml at
  tiny width (``--opts`` only) with the PMV rect recipe: one epoch of train,
  checkpoint, eval and test, then a resume with SOLVER.MAX_EPOCH 2 that
  restores the BatchNorm buffers; the recipe with its pretrain (a seeded
  image checkpoint through the registry) and with MODEL_VIS.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine.train import _make_pm_eval_step
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu_torch.data.synthetic import Synthetic
from pmv_tpu_torch.engine.steps import (
    forward_by_orientation,
    init_state,
    make_eval_step,
    make_feat_step,
    make_train_step,
    select_by_orientation,
)
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax
from test_torch_port_uniformer import tiny_cfg
from torch_port_util import (  # noqa: F401
    depthwise_calls,
    jax_train_draws,
    numpy_tree,
    port_cfg,
    random_batch_stats,
    random_params,
    tensorboard_without_tensorflow,
    to_np,
)

ROOT = Path(__file__).resolve().parents[1]
RECT = (96, 64)
PM = np.array([True, False, False, True])


def _train_cfg(rect=None, frozen_bn=False):
    cfg = tiny_cfg(rect=rect)
    cfg.DATA.TRAIN_CROP_SIZE = 64
    cfg.AUG.ENABLE = True
    cfg.AUG.AA_TYPE = "rand-m7-n1-mstd0.5-inc1"
    cfg.AUG.RE_PROB = 0.75
    cfg.MIXUP.ENABLE = True
    cfg.MODEL.LOSS_FUNC = "soft_cross_entropy"
    cfg.MODEL.FROZEN_BN = frozen_bn
    cfg.SOLVER.OPTIMIZING_METHOD = "adamw"
    cfg.SOLVER.BASE_LR = 1e-3
    cfg.SOLVER.WEIGHT_DECAY = 0.05
    cfg.SOLVER.CLIP_GRAD_L2NORM = 1.0
    cfg.SOLVER.ZERO_WD_1D_PARAM = True
    cfg.TPU.DEVICE_PREFETCH = 0
    return cfg


def _batch(cfg, seed, pm=None):
    h, w = cfg.DATA.TRAIN_CROP_SIZE_RECT or (64, 64)
    rng = np.random.default_rng(seed)
    b = 2 if pm is None else len(pm)
    batch = {"frames": rng.integers(0, 256, (b, cfg.DATA.NUM_FRAMES, h, w, 3), np.uint8),
             "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, b)}
    if pm is not None:
        batch["pm"] = pm
    return batch


def _jax_state(cfg, batch, seed):
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    state, tx = jsteps.init_state(cfg, jmodel, {k: jnp.asarray(v) for k, v in batch.items()},
                                  jax.random.PRNGKey(0))
    params = random_params(numpy_tree(state.params), seed)
    stats = random_batch_stats(numpy_tree(state.batch_stats), seed + 1)
    return jmodel, state.replace(params=params, batch_stats=stats,
                                 opt_state=tx.init(params)), tx


def _port(cfg, jstate):
    pcfg = port_cfg(cfg)
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    load_jax_params(model, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    return pcfg, model


def _assert_state_matches(model, jstate, lrs):
    """Running statistics to atol 2e-4, rtol 1e-4; weights to atol 1e-5, but for the
    few elements whose gradient is near float noise, which Adam's first
    steps (about lr x sign(g)) may move either way: those within 2 x the
    summed LRs, and no more than 1e-3 of the elements."""
    ref = state_dict_from_jax(numpy_tree({"params": jstate.params,
                                          "batch_stats": jstate.batch_stats}))
    got = model.state_dict()
    n_off = n = 0
    for name, value in ref.items():
        if name.endswith("num_batches_tracked") or name == "blocks4.0.mlp.fc2.bias":
            # The last block's fc2 bias reaches the loss only as a per-channel
            # shift into the final BatchNorm in train mode: its gradient is
            # float noise in both.
            continue
        a, b = got[name].numpy(), value.numpy()
        if name.endswith("qkv.bias"):
            # The keys' bias shifts every score of a query by one constant,
            # which softmax ignores: its gradient is float noise as well.
            c = len(a) // 3
            a, b = np.delete(a, np.s_[c:2 * c]), np.delete(b, np.s_[c:2 * c])
        if "running" in name:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-4, err_msg=name)
            continue
        np.testing.assert_allclose(a, b, atol=2.0001 * sum(lrs), rtol=0, err_msg=name)
        n_off += int((np.abs(a - b) > 1e-5).sum())
        n += a.size
    assert n_off <= 1e-3 * n, f"{n_off} of {n} weights off by more than 1e-5"


def _run_steps(cfg, batches, model_pm=False):
    rng = jax.random.PRNGKey(3)
    lrs = [1e-3, 7e-4]
    jmodel, jstate, tx = _jax_state(cfg, batches[0], 4)
    before = numpy_tree(jstate.batch_stats)
    jstep = jax.jit(jsteps.make_train_step(cfg, jmodel, tx,
                                           model_pm=jmodel if model_pm else None))
    pcfg, model = _port(cfg, jstate)
    state = init_state(pcfg, model)
    step = make_train_step(pcfg, device="cpu")
    for i, (batch, lr) in enumerate(zip(batches, lrs)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng, lr)
        m = step(state, batch, lr, jax_train_draws(cfg, rng, i, batch["frames"].shape))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert float(m["top1_err"]) == float(jm["top1_err"])
        assert float(m["top5_err"]) == float(jm["top5_err"])
        assert not bool(m["nan"])
    _assert_state_matches(model, jstate, lrs)
    return model, before, jstate


@pytest.mark.parametrize("frozen_bn", [False, True], ids=["bn", "frozen_bn"])
def test_train_step_matches_jax(frozen_bn, depthwise_calls):  # noqa: F811
    cfg = _train_cfg(frozen_bn=frozen_bn)
    model, before, jstate = _run_steps(cfg, [_batch(cfg, seed) for seed in (0, 1)])
    moved = [not np.allclose(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(before), jax.tree_util.tree_leaves(numpy_tree(jstate.batch_stats)))]
    assert not any(moved) if frozen_bn else all(moved)
    assert int(model.norm.num_batches_tracked) == (0 if frozen_bn else 2)
    assert len(depthwise_calls) == 2 * 4  # one DPE per block in each forward


def test_pm_train_step_matches_jax_select(depthwise_calls):  # noqa: F811
    cfg = _train_cfg(rect=RECT)
    batches = [_batch(cfg, seed, PM) for seed in (0, 1)]
    model, _, _ = _run_steps(cfg, batches, model_pm=True)
    # Per forward: the whole batch landscape, then transposed.
    assert len(depthwise_calls) == 2 * 2 * 4
    assert depthwise_calls[0][2:4] == (24, 16) and depthwise_calls[4][2:4] == (16, 24)
    # One update of the statistics per step: the landscape pass's.
    assert int(model.norm.num_batches_tracked) == 2


def test_per_group_split_is_not_the_select_with_batchnorm():
    """In train mode BatchNorm's batch statistics cross rows, so running
    each orientation group alone (MViT's exact split) gives other outputs
    than JAX's whole-batch select; at eval, with running statistics, the
    two agree."""
    cfg = port_cfg(_train_cfg(rect=RECT))
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=3)
    x = torch.randn(len(PM), 4, *RECT, 3, generator=torch.Generator().manual_seed(0))
    for train, apart in ((True, True), (False, False)):
        model.train(train)
        with torch.no_grad():
            split = forward_by_orientation(model, x, PM)
            select = select_by_orientation(model, x, PM)
        diff = float((split - select).abs().max())
        assert diff > 1e-3 if apart else diff < 1e-5


def test_pm_eval_and_feature_steps_match_jax():
    cfg = _train_cfg(rect=RECT)
    cfg.AUG.ENABLE = False
    frames = _batch(cfg, 5, PM)["frames"]
    jmodel, jstate, _ = _jax_state(cfg, _batch(cfg, 5, PM), 6)
    jpm = np.asarray(jax.jit(_make_pm_eval_step(cfg, jmodel, jmodel))(
        jstate, jnp.asarray(frames), jnp.asarray(PM)))
    jfeat = np.asarray(jax.jit(jsteps.make_feat_step(cfg, jmodel))(jstate, jnp.asarray(frames)))

    pcfg, model = _port(cfg, jstate)
    got = to_np(make_eval_step(pcfg, model, device="cpu")(frames, PM))
    np.testing.assert_allclose(got, jpm, atol=2e-4, rtol=1e-4)
    feat = make_feat_step(pcfg, model, device="cpu")(frames).numpy()
    assert feat.shape == (len(PM), 32)
    np.testing.assert_allclose(feat, jfeat, atol=2e-4, rtol=1e-4)


UNIFORMER_CFG = str(ROOT / "configs" / "Kinetics" / "UNIFORMER_S_16x4.yaml")


def _run_net_argv(out, max_epoch):
    """The PMV rect recipe (exps/PMV/run_Uniformer_PMV.sh, rect 256x192) at
    tiny width and a rect crop of 48x32, on the Synthetic dataset."""
    return ["--cfg", UNIFORMER_CFG, "--device", "cpu", "--opts",
            "DATA.TRAIN_JITTER_ASPECT_RELATIVE", "[]",
            "DATA.TRAIN_JITTER_SCALES_RELATIVE", "[]",
            "DATA.TRAIN_JITTER_SCALES_AUTO_ADJUST", "True",
            "DATA.TRAIN_CROP_SIZE_RECT", "[48,32]",
            "UNIFORMER.PRETRAIN_NAME", "",
            "TENSORBOARD.ENABLE", "False",
            "UNIFORMER.EMBED_DIM", "[8,16,16,32]", "UNIFORMER.DEPTH", "[1,1,1,1]",
            "UNIFORMER.HEAD_DIM", "8",
            "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
            "MODEL.NUM_CLASSES", "5", "TRAIN.MIXED_PRECISION", "False",
            "TRAIN.DATASET", "synthetic", "TEST.DATASET", "synthetic",
            "TRAIN.BATCH_SIZE", "8", "TEST.BATCH_SIZE", "8",
            "TRAIN.EVAL_PERIOD", "1", "TRAIN.CHECKPOINT_PERIOD", "1",
            "TEST.NUM_ENSEMBLE_VIEWS", "2", "DATA_LOADER.NUM_WORKERS", "2",
            "NUM_GPUS", "1",  # the yaml's 8 would make eight processes
            "SOLVER.MAX_EPOCH", str(max_epoch), "OUTPUT_DIR", str(out)]


def test_run_net_trains_checkpoints_resumes_and_tests_uniformer(tmp_path):
    out = tmp_path / "job"
    assert run_net.main(_run_net_argv(out, 1)) == 0
    log = (out / "stdout.log").read_text()
    assert '"split": "test_final"' in log
    ckpt = torch.load(out / "checkpoints" / "checkpoint_epoch_00001.pyth", weights_only=True)
    stats = ckpt["model_state"]
    assert int(stats["norm.num_batches_tracked"]) == 8  # 64 videos, 8 a step
    assert float(stats["blocks1.0.norm1.running_mean"].abs().max()) > 0

    # Restored as train() restores it: the BatchNorm buffers come back equal.
    from pmv_tpu_torch.config.defaults import assert_and_infer_cfg
    from pmv_tpu_torch.config.parser import load_config, parse_args

    argv = _run_net_argv(out, 2)
    cfg = assert_and_infer_cfg(load_config(parse_args(argv), UNIFORMER_CFG))
    state = init_state(cfg, build_model(cfg, device="cpu", seed=cfg.RNG_SEED))
    assert cu.load_train_checkpoint(cfg, state) == 1
    restored = state.model.state_dict()
    for name in [n for n in stats if "running" in n or "num_batches" in n]:
        assert torch.equal(restored[name], stats[name]), name

    assert run_net.main(argv) == 0
    log = (out / "stdout.log").read_text()
    assert "Load from last checkpoint" in log and "Start epoch: 2" in log
    second = torch.load(out / "checkpoints" / "checkpoint_epoch_00002.pyth", weights_only=True)
    assert int(second["model_state"]["norm.num_batches_tracked"]) == 16
    stats_lines = [line for line in log.splitlines() if "json_stats: " in line]
    assert '"split": "test_final"' in stats_lines[-1]


@pytest.mark.parametrize("part", ["pretrain", "model_vis"])
def test_run_net_runs_the_recipe_with_its_pretrain_and_visualization(tmp_path, monkeypatch, part):
    """The yaml's own UNIFORMER.PRETRAIN_NAME (uniformer_small_in1k, here a
    seeded image checkpoint of 1000 classes under PMV_PRETRAIN_ROOT: its
    2-D kernels inflated, its head dropped, the statistics at their init),
    and its TensorBoard writer with MODEL_VIS (Grad-CAM at UniFormer's tap,
    the weight histograms)."""
    argv = _run_net_argv(tmp_path / "job", 1)
    if part == "pretrain":
        from test_torch_port_inflation import image_checkpoint

        monkeypatch.setattr(Synthetic, "NUM_VIDEOS", 16)  # 2 train steps
        monkeypatch.setenv("PMV_PRETRAIN_ROOT", str(tmp_path))
        argv[argv.index("UNIFORMER.PRETRAIN_NAME") + 1] = "uniformer_small_in1k"
        argv += ["TEST.ENABLE", "False"]
        cfg = port_cfg(tiny_cfg())
        cfg.MODEL.NUM_CLASSES = 5
        image_checkpoint(build_model(cfg, device="cpu"), tmp_path / "uniformer_small_in1k.pth",
                         seed=3)
    else:
        tensorboard_without_tensorflow()
        argv[argv.index("TENSORBOARD.ENABLE") + 1] = "True"
        argv += ["TRAIN.ENABLE", "False", "TEST.ENABLE", "False",
                 "TENSORBOARD.MODEL_VIS.ENABLE", "True",
                 "TENSORBOARD.MODEL_VIS.MODEL_WEIGHTS", "True"]
    assert run_net.main(argv) == 0
    log = (tmp_path / "job" / "stdout.log").read_text()
    if part == "pretrain":
        assert "Loading UniFormer pretrain 'uniformer_small_in1k'" in log
        assert "Dropping head.weight" in log and cu.has_checkpoint(str(tmp_path / "job"))
    else:
        events = list((tmp_path / "job" / "runs-synthetic").glob("events.out.tfevents.*"))
        assert events and not cu.has_checkpoint(str(tmp_path / "job"))
