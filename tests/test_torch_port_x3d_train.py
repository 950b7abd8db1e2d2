"""The port's X3D train path and precise BN against the JAX package's.

On configs/tiny_x3d_synthetic.yaml at DEPTH_FACTOR 1.0 (``--opts``-style
overrides: blocks [1, 2, 5, 3], 7 stride-1 channelwise convs a forward),
64 x 64 crops (rect: 64 x 48), float32 on the CPU, from the same
parameters and BatchNorm statistics (tests/test_torch_port_x3d.py's
``jax_variables``):

- one train step of the config's recipe (cross-entropy, SGD with Nesterov
  momentum and weight decay, the head's dropout at MODEL.DROPOUT_RATE 0.5)
  against the jitted JAX ``make_train_step``, the dropout mask read off the
  JAX model under the step's dropout key: loss and grad norm to rtol 1e-4,
  top-1/top-5 equal, the updated weights to atol 1e-5 (lr 0.05 times
  gradients that agree to about 1e-5 of their scale) and the running
  statistics to rtol 1e-4 (atol 1e-6);
- the portrait (``pm``) train step on a mixed batch of the rect crop
  against ``make_train_step(model_pm=...)``'s select;
- precise BN against ``pmv_tpu.engine.precise_bn`` on the same weights and
  batches (a list of batches serves as both loaders), atol 1e-5, rtol 1e-4
  (JAX recovers each batch statistic from its momentum update, ten times
  its float32 rounding); ``num_batches_tracked`` unchanged;
- ``run_net --device cpu`` on the tiny config: one epoch that logs the
  precise-BN line and checkpoints the precise statistics, then a resume to
  epoch 2 and the test.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.engine import precise_bn as jprecise_bn
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.parallel import mesh as mesh_lib
from pmv_tpu_torch.data.loader import construct_loader
from pmv_tpu_torch.engine.precise_bn import calculate_and_update_precise_bn
from pmv_tpu_torch.engine.steps import init_state, make_train_step
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax
from test_torch_port_x3d import DEPTH_1, TINY_X3D, jax_variables, tiny_x3d_cfg
from torch_port_util import (  # noqa: F401
    depthwise_calls,
    jax_dropout_key,
    jax_dropout_masks,
    jax_train_draws,
    numpy_tree,
    port_cfg,
)

RECT = ("DATA.TRAIN_CROP_SIZE_RECT", "[64,48]")
PM = np.array([True, False, False, True])
K1_PER_FORWARD = 7


def _cfg(*opts):
    return tiny_x3d_cfg(*DEPTH_1, "DATA.TRAIN_CROP_SIZE", "64", "TRAIN.MIXED_PRECISION",
                        "False", *opts)


def _batch(cfg, seed, pm=None):
    h, w = cfg.DATA.TRAIN_CROP_SIZE_RECT or (64, 64)
    rng = np.random.default_rng(seed)
    b = 4 if pm is None else len(pm)
    batch = {"frames": rng.integers(0, 256, (b, cfg.DATA.NUM_FRAMES, h, w, 3), np.uint8),
             "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, b)}
    if pm is not None:
        batch["pm"] = pm
    return batch


def _jax_state(cfg, batch, seed):
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state, tx = jsteps.init_state(cfg, jmodel, jbatch, jax.random.PRNGKey(0))
    variables = jax_variables(jmodel, batch["frames"].astype(np.float32), seed)
    return jmodel, state.replace(params=variables["params"],
                                 batch_stats=variables["batch_stats"],
                                 opt_state=tx.init(variables["params"])), tx


def _port(cfg, jstate):
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    load_jax_params(model, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    return model


def _assert_state_matches(model, jstate):
    want = state_dict_from_jax(numpy_tree({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}))
    got = model.state_dict()
    for name, value in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        tol = dict(atol=1e-6, rtol=1e-4) if "running" in name else dict(atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), err_msg=name, **tol)


def _step_matches_jax(cfg, batch, model_pm=False):
    rng, lr = jax.random.PRNGKey(3), 0.05
    jmodel, jstate, tx = _jax_state(cfg, batch, 4)
    jstep = jax.jit(jsteps.make_train_step(cfg, jmodel, tx,
                                           model_pm=jmodel if model_pm else None))
    (mask,) = jax_dropout_masks(jmodel, {"params": jstate.params,
                                         "batch_stats": jstate.batch_stats},
                                batch["frames"], jax_dropout_key(rng, 0))
    model = _port(cfg, jstate)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = init_state(port_cfg(cfg), model)
    step = make_train_step(port_cfg(cfg), device="cpu")
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng, lr)
    draws = {**jax_train_draws(cfg, rng, 0, batch["frames"].shape),
             "dropout": torch.tensor(mask, dtype=torch.float32)}
    m = step(state, batch, lr, draws)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert float(m["top1_err"]) == float(jm["top1_err"])
    assert float(m["top5_err"]) == float(jm["top5_err"])
    _assert_state_matches(model, jstate)
    after = model.state_dict()
    moved = [n for n in after if "running" in n and not torch.equal(after[n], before[n])]
    assert len(moved) == sum("running" in n for n in after)
    return model


def test_sgd_train_step_matches_jax(depthwise_calls):  # noqa: F811
    cfg = _cfg()
    assert cfg.SOLVER.OPTIMIZING_METHOD == "sgd" and cfg.SOLVER.NESTEROV
    model = _step_matches_jax(cfg, _batch(cfg, 0))
    assert len(depthwise_calls) == K1_PER_FORWARD
    assert int(model.head.conv_5_bn.num_batches_tracked) == 1


def test_pm_train_step_matches_jax_select(depthwise_calls):  # noqa: F811
    """BatchNorm crosses rows, so the whole batch runs landscape (its
    statistics move the running ones), then transposed, then the select."""
    cfg = _cfg(*RECT)
    model = _step_matches_jax(cfg, _batch(cfg, 1, PM), model_pm=True)
    assert len(depthwise_calls) == 2 * K1_PER_FORWARD
    assert depthwise_calls[0][2:4] != depthwise_calls[K1_PER_FORWARD][2:4]  # transposed
    assert int(model.head.conv_5_bn.num_batches_tracked) == 1


@pytest.mark.parametrize("num_batches", [2, 5])
def test_precise_bn_matches_jax(num_batches):
    """Over ``min(NUM_BATCHES_PRECISE, len(loader))`` batches: 2 of 3, or
    all 3 when 5 are asked for."""
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
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
        assert not torch.equal(got[name], before[name]), name
    for name, value in before.items():  # the weights stay as they were
        if "running" not in name:
            assert torch.equal(got[name], value), name


def test_precise_bn_leaves_a_model_without_batchnorm_alone():
    from pmv_tpu_torch.entry import mvitv2_s_cfg

    cfg = mvitv2_s_cfg(tiny=True)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    state = init_state(cfg, model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    calculate_and_update_precise_bn([{"frames": None}], state, cfg, "cpu")
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def _run_net_argv(out, max_epoch, *opts):
    return ["--cfg", TINY_X3D, "--device", "cpu", "--opts", "OUTPUT_DIR", str(out),
            "SOLVER.MAX_EPOCH", str(max_epoch), *opts]


def test_run_net_trains_precise_bn_checkpoints_resumes_and_tests_x3d(tmp_path):
    out = tmp_path / "job"
    assert run_net.main(_run_net_argv(out, 1)) == 0
    log = (out / "stdout.log").read_text()
    lines = log.splitlines()
    order = [next(i for i, line in enumerate(lines) if key in line) for key in (
        '"_type": "train_epoch"', "Updated precise BN stats over 2 batches",
        "Saved checkpoint to", '"_type": "val_epoch"', '"split": "test_final"')]
    assert order == sorted(order)

    # The checkpoint holds the precise statistics: precise BN run again from
    # its weights over the same train batches gives them back.
    ckpt = torch.load(out / "checkpoints" / "checkpoint_epoch_00001.pyth", weights_only=True)
    saved = ckpt["model_state"]
    from pmv_tpu_torch.config.defaults import assert_and_infer_cfg
    from pmv_tpu_torch.config.parser import load_config, parse_args

    argv = _run_net_argv(out, 2)
    cfg = assert_and_infer_cfg(load_config(parse_args(argv), TINY_X3D))
    model = build_model(cfg, device="cpu", seed=cfg.RNG_SEED)
    model.load_state_dict(saved, strict=True)
    for name, buf in model.named_buffers():
        if "running" in name:
            buf.fill_(float("nan"))
    loader = construct_loader(cfg, "train")
    loader.set_epoch(0)
    calculate_and_update_precise_bn(loader, init_state(cfg, model), cfg, "cpu")
    for name, value in model.state_dict().items():
        assert torch.equal(value, saved[name]), name
    assert int(saved["head.conv_5_bn.num_batches_tracked"]) == 8  # 64 videos, 8 a step

    skip = len((out / "stdout.log").read_text())
    assert run_net.main(argv) == 0
    log = (out / "stdout.log").read_text()[skip:]
    assert "Load from last checkpoint" in log and "Start epoch: 2" in log
    assert log.count("Updated precise BN stats over 2 batches") == 1
    second = torch.load(out / "checkpoints" / "checkpoint_epoch_00002.pyth", weights_only=True)
    assert int(second["model_state"]["head.conv_5_bn.num_batches_tracked"]) == 16
    stats_lines = [line for line in log.splitlines() if "json_stats: " in line]
    assert '"split": "test_final"' in stats_lines[-1]


def test_run_net_needs_a_card_without_device_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_net.main(["--cfg", TINY_X3D, "--opts", "OUTPUT_DIR", str(tmp_path)])
    assert not cu.has_checkpoint(str(tmp_path))
