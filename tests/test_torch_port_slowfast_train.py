"""The port's SlowFast train path, portrait steps and precise BN against the
JAX package's.

On configs/tiny_slowfast_synthetic.yaml (the slow pathway at 2 of 8
frames, widths 8 and 2, ResNet-18 depth of bottleneck blocks), 32 x 32
crops (rect: 32 x 24), float32 on the CPU, from the same parameters and
BatchNorm statistics (tests/test_torch_port_resnet.py's ``jax_variables``;
the JAX stem at TPU.FOLD_STEM, its default):

- one train step of the config's recipe (cross-entropy, SGD with Nesterov
  momentum and weight decay, the head's dropout at MODEL.DROPOUT_RATE 0.5)
  against the jitted JAX ``make_train_step``, the dropout mask read off the
  JAX model under the step's dropout key, JAX's ReLUs taking the port's
  decisions (``jax_relu_decisions``: a ReLU input within a rounding of 0
  moves this net's float32 gradients by percents): loss and grad norm to
  rtol 1e-4, top-1/top-5 equal, the SGD update (the weights' change, over
  the largest change: the gradient it holds) to atol 2e-4, the running
  statistics to rtol 1e-4 (atol 2e-5: 0.1 x a batch statistic, held as
  precise BN holds those);
- the portrait (``pm``) train step on a mixed batch of the rect crop
  against ``make_train_step(model_pm=...)``'s select (the pathways of the
  transposed clip), and the pm eval step against ``_make_pm_eval_step``;
- precise BN over pathway lists against ``pmv_tpu.engine.precise_bn``
  (atol 2e-4, rtol 1e-4: JAX recovers each batch statistic from its
  momentum update, ten times its float32 rounding, and the last stage's
  BatchNorms here normalize 8 values a channel); ``num_batches_tracked``
  unchanged;
- ``run_net --device cpu`` on the tiny config: one epoch that trains, runs
  precise BN, checkpoints, evaluates and tests, then a resume to epoch 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.engine import precise_bn as jprecise_bn
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine.train_state import TrainState
from pmv_tpu.engine.train import _make_pm_eval_step
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models import optimizer as joptim
from pmv_tpu.parallel import mesh as mesh_lib
from pmv_tpu_torch.engine.precise_bn import calculate_and_update_precise_bn
from pmv_tpu_torch.engine.steps import init_state, make_eval_step, make_train_step
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.tools.grad_witness import relu_decisions
from pmv_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax
from test_torch_port_resnet import TINY_SLOWFAST, jax_variables, tiny_cfg
from torch_port_util import (  # noqa: F401
    depthwise_calls,
    jax_dropout_key,
    jax_dropout_masks,
    jax_relu_decisions,
    jax_train_draws,
    numpy_tree,
    port_cfg,
)

RECT = ("DATA.TRAIN_CROP_SIZE_RECT", "[32,24]")
PM = np.array([True, False, False, True])
LR = 0.05


def _cfg(*opts):
    return tiny_cfg("TRAIN.MIXED_PRECISION", "False", *opts)


def _batch(cfg, seed, pm=None):
    h, w = cfg.DATA.TRAIN_CROP_SIZE_RECT or (32, 32)
    rng = np.random.default_rng(seed)
    b = 4 if pm is None else len(pm)
    batch = {"frames": rng.integers(0, 256, (b, cfg.DATA.NUM_FRAMES, h, w, 3), np.uint8),
             "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, b)}
    if pm is not None:
        batch["pm"] = pm
    return batch


def _pathways(cfg, frames):
    """The JAX model's input for uint8 ``frames``, as its eval step packs it."""
    x = jsteps.make_eval_preprocess_fn(cfg)(jnp.asarray(frames))
    return jsteps.pack_pathways(cfg, x)


def _jax_state(cfg, batch, seed):
    """The JAX model, its TrainState at step 0 on numpy-drawn variables (no
    init run: ``jax_variables`` reads the tree off ``jax.eval_shape``), and
    its optimizer."""
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    variables = jax_variables(jmodel, _pathways(cfg, batch["frames"]), seed)
    tx = joptim.construct_optimizer(variables["params"], cfg)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    return jmodel, state, tx


def _port(cfg, jstate):
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    load_jax_params(model, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    return model


def _assert_state_matches(model, jstate, before):
    """The weights' change (the SGD update) over the largest change to atol
    2e-4; the running statistics, which move by 0.1 x a batch statistic, to
    rtol 1e-4 and 0.1 x precise BN's atol, 2e-5, every one of them moved."""
    want = state_dict_from_jax(numpy_tree({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}))
    got = model.state_dict()
    scale = max(float((before[n] - v).abs().max()) for n, v in want.items()
                if "running" not in n and not n.endswith("num_batches_tracked"))
    for name, value in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        if "running" in name:
            np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=2e-5, rtol=1e-4,
                                       err_msg=name)
            assert not torch.equal(got[name], before[name]), name
            continue
        np.testing.assert_allclose((before[name] - got[name]).numpy() / scale,
                                   (before[name] - value).numpy() / scale, atol=2e-4, rtol=0,
                                   err_msg=name)


def _step_matches_jax(cfg, batch, model_pm=False):
    rng = jax.random.PRNGKey(3)
    jmodel, jstate, tx = _jax_state(cfg, batch, 4)
    (mask,) = jax_dropout_masks(jmodel, {"params": jstate.params,
                                         "batch_stats": jstate.batch_stats},
                                _pathways(cfg, batch["frames"]), jax_dropout_key(rng, 0))
    model = _port(cfg, jstate)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = init_state(port_cfg(cfg), model)
    step = make_train_step(port_cfg(cfg), device="cpu")
    draws = {**jax_train_draws(cfg, rng, 0, batch["frames"].shape),
             "dropout": torch.tensor(mask, dtype=torch.float32)}
    with relu_decisions() as decisions:
        m = step(state, batch, LR, draws)
    jstep = jax.jit(jsteps.make_train_step(cfg, jmodel, tx,
                                           model_pm=jmodel if model_pm else None))
    with jax_relu_decisions(decisions):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng, LR)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert float(m["top1_err"]) == float(jm["top1_err"])
    assert float(m["top5_err"]) == float(jm["top5_err"])
    _assert_state_matches(model, jstate, before)
    return model


@pytest.mark.parametrize("portrait", [False, True], ids=["landscape", "pm"])
def test_sgd_train_step_matches_jax(portrait, depthwise_calls):  # noqa: F811
    """The landscape step, and the pm step on a mixed batch of the rect
    crop: BatchNorm crosses rows, so the whole batch runs landscape (its
    statistics move the running ones), then transposed, then the select."""
    cfg = _cfg(*RECT) if portrait else _cfg()
    assert cfg.SOLVER.OPTIMIZING_METHOD == "sgd" and cfg.SOLVER.NESTEROV
    model = _step_matches_jax(cfg, _batch(cfg, int(portrait), PM if portrait else None),
                              model_pm=portrait)
    assert not depthwise_calls
    assert int(model.s1_fuse.bn.num_batches_tracked) == 1


def test_pm_eval_step_matches_jax():
    """Each row in its orientation (the pathways of the transposed clip for
    the portrait rows) against JAX's whole-batch select."""
    cfg = _cfg(*RECT)
    batch = _batch(cfg, 2, PM)
    jmodel, jstate, _ = _jax_state(cfg, batch, 5)
    want = jax.jit(_make_pm_eval_step(cfg, jmodel, jmodel))(
        jstate, jnp.asarray(batch["frames"]), jnp.asarray(PM))
    model = _port(cfg, jstate)
    got = make_eval_step(port_cfg(cfg), model, device="cpu")(batch["frames"], PM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)
    plain = make_eval_step(port_cfg(cfg), model, device="cpu")(batch["frames"])
    np.testing.assert_allclose(got[~PM].numpy(), plain[~PM].numpy(), atol=1e-6, rtol=0)
    assert float((got[PM] - plain[PM]).abs().max()) > 1e-4  # the portrait rows ran transposed


@pytest.mark.parametrize("num_batches", [2, 5])
def test_precise_bn_matches_jax(num_batches):
    """Over ``min(NUM_BATCHES_PRECISE, len(loader))`` batches of both
    pathways: 2 of 3, or all 3 when 5 are asked for."""
    cfg = _cfg("BN.NUM_BATCHES_PRECISE", str(num_batches))
    batches = [_batch(cfg, seed) for seed in (5, 6, 7)]
    jmodel, jstate, _ = _jax_state(cfg, batches[0], 8)
    want = jprecise_bn.calculate_and_update_precise_bn(
        batches, jstate, cfg, jmodel, mesh_lib.create_mesh(devices=jax.devices()[:1]))
    model = _port(cfg, jstate)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = init_state(port_cfg(cfg), model)
    assert calculate_and_update_precise_bn(batches, state, port_cfg(cfg), "cpu") is state
    got = model.state_dict()
    ref = state_dict_from_jax(numpy_tree({"params": {}, "batch_stats": want.batch_stats}))
    assert len(ref) == sum("running" in n or "num_batches" in n for n in got)
    for name, value in ref.items():
        if name.endswith("num_batches_tracked"):
            assert torch.equal(got[name], before[name]), name
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=2e-4, rtol=1e-4,
                                   err_msg=name)
        assert not torch.equal(got[name], before[name]), name
    for name, value in before.items():  # the weights stay as they were
        if "running" not in name:
            assert torch.equal(got[name], value), name


def _run_net_argv(out, max_epoch):
    return ["--cfg", TINY_SLOWFAST, "--device", "cpu", "--opts", "OUTPUT_DIR", str(out),
            "SOLVER.MAX_EPOCH", str(max_epoch)]


def test_run_net_trains_checkpoints_resumes_and_tests_slowfast(tmp_path):
    out = tmp_path / "job"
    assert run_net.main(_run_net_argv(out, 1)) == 0
    lines = (out / "stdout.log").read_text().splitlines()
    order = [next(i for i, line in enumerate(lines) if key in line) for key in (
        '"_type": "train_epoch"', "Updated precise BN stats over 2 batches",
        "Saved checkpoint to", '"_type": "val_epoch"', '"split": "test_final"')]
    assert order == sorted(order)
    ckpt = torch.load(out / "checkpoints" / "checkpoint_epoch_00001.pyth", weights_only=True)
    assert int(ckpt["model_state"]["s1_fuse.bn.num_batches_tracked"]) == 8  # 64 videos, 8 a step
    assert "s5.pathway1_res1.branch2.c_bn.running_var" in ckpt["model_state"]

    skip = len((out / "stdout.log").read_text())
    assert run_net.main(_run_net_argv(out, 2)) == 0
    log = (out / "stdout.log").read_text()[skip:]
    assert "Load from last checkpoint" in log and "Start epoch: 2" in log
    second = torch.load(out / "checkpoints" / "checkpoint_epoch_00002.pyth", weights_only=True)
    assert int(second["model_state"]["s1_fuse.bn.num_batches_tracked"]) == 16
    stats_lines = [line for line in log.splitlines() if "json_stats: " in line]
    assert '"split": "test_final"' in stats_lines[-1]
