"""The port's portrait (``pm``) steps against the JAX package's.

The JAX package runs the whole batch through both orientations (the
landscape model and the portrait specialization, ``hw_switch=True``, over
the same parameters) and selects per row; the port runs each row once, in
its own orientation, through one module. At tiny MViT width with a rect
crop [16, 12], SWITCH_AUTO and 4 frames (so that the stride-1 3x3x3
depthwise pools run in both orientations), float32 on the CPU:

- the pm train step (RandAugment, erasing, MixUp/CutMix, soft
  cross-entropy, AdamW with clipping) against the jitted JAX
  ``make_train_step(model_pm=...)`` from the same parameters and the same
  draws, two steps: loss and grad norm to rtol 1e-5, top-1/top-5 equal,
  parameters to atol 1e-5, as tests/test_torch_port_train.py holds the
  landscape step;
- the pm eval step against JAX's ``_make_pm_eval_step``: atol 1e-5, its
  landscape rows the plain eval step's (atol 1e-6);
- with DropPath and the head's dropout on, the per-row split equals the
  select of two whole-batch forwards fed the same masks (atol 1e-6), which
  is what makes the split exact against JAX's select.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _mvitv2_s_cfg
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine.train import _make_pm_eval_step
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu_torch.engine.steps import (
    forward_by_orientation,
    init_state,
    make_eval_step,
    make_train_step,
)
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax
from torch_port_util import depthwise_calls, jax_train_draws, port_cfg, random_params, to_np  # noqa: F401

RECT = [16, 12]
PM = np.array([True, False, False, True])


def _pm_cfg(train=True):
    cfg = _mvitv2_s_cfg(tiny=True)
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.DATA.TRAIN_CROP_SIZE_RECT = RECT
    cfg.DATA.TRAIN_CROP_SIZE_RECT_SWITCH_AUTO = True
    cfg.AUG.ENABLE = train
    cfg.AUG.AA_TYPE = "rand-m7-n1-mstd0.5-inc1"
    cfg.AUG.RE_PROB = 0.75
    cfg.SOLVER.BASE_LR = 1e-3
    cfg.TPU.DEVICE_PREFETCH = 0
    return cfg


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (len(PM), cfg.DATA.NUM_FRAMES, *RECT, 3), np.uint8)
    labels = rng.integers(0, cfg.MODEL.NUM_CLASSES, len(PM))
    return {"frames": frames, "labels": labels, "pm": PM}


def _jax_state(cfg, batch, seed):
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    jport = jax_build_model(cfg, hw_switch=True, dtype=jnp.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state, tx = jsteps.init_state(cfg, jmodel, jbatch, jax.random.PRNGKey(0))
    params = random_params(jax.tree_util.tree_map(np.asarray, state.params), seed)
    return jmodel, jport, state.replace(params=params, opt_state=tx.init(params)), tx


def test_pm_train_step_matches_jax(depthwise_calls):  # noqa: F811
    cfg = _pm_cfg()
    batches = [_batch(cfg, seed) for seed in (0, 1)]
    rng = jax.random.PRNGKey(3)
    lrs = [1e-3, 7e-4]
    jmodel, jport, jstate, tx = _jax_state(cfg, batches[0], 4)
    jstep = jax.jit(jsteps.make_train_step(cfg, jmodel, tx, model_pm=jport))

    pcfg = port_cfg(cfg)
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    load_jax_params(model, jstate.params)
    state = init_state(pcfg, model)
    step = make_train_step(pcfg, device="cpu")

    for i, (batch, lr) in enumerate(zip(batches, lrs)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng, lr)
        draws = jax_train_draws(cfg, rng, i, batch["frames"].shape)
        m = step(state, batch, lr, draws)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        assert float(m["top1_err"]) == float(jm["top1_err"])
        assert float(m["top5_err"]) == float(jm["top5_err"])
        assert not bool(m["nan"])
    # Per forward, one group of each orientation: block 0's q-pool and block
    # 1's K and V pools, on the 4x3 grid and on its transpose.
    assert len(depthwise_calls) == 2 * 2 * 3
    assert sorted(s[2:4] for s in depthwise_calls) == [(3, 4)] * 6 + [(4, 3)] * 6

    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = model.state_dict()
    for name, value in ref.items():
        if name.endswith("norm_k.bias"):  # float noise that Adam scales to +-lr
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


def test_pm_eval_step_matches_jax():
    cfg = _pm_cfg(train=False)
    batch = _batch(cfg, 5)
    jmodel, jport, jstate, _ = _jax_state(cfg, batch, 6)
    jpm = np.asarray(jax.jit(_make_pm_eval_step(cfg, jmodel, jport))(
        jstate, jnp.asarray(batch["frames"]), jnp.asarray(PM)))
    jplain = np.asarray(jax.jit(jsteps.make_eval_step(cfg, jmodel))(
        jstate, jnp.asarray(batch["frames"])))

    pcfg = port_cfg(cfg)
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    load_jax_params(model, jstate.params)
    eval_step = make_eval_step(pcfg, model, device="cpu")
    got = to_np(eval_step(batch["frames"], PM))
    plain = to_np(eval_step(batch["frames"]))

    np.testing.assert_allclose(got, jpm, atol=1e-5, rtol=0)
    np.testing.assert_allclose(plain, jplain, atol=1e-5, rtol=0)
    # The landscape rows are the plain step's, up to the float noise of a
    # matmul at another batch size.
    np.testing.assert_allclose(got[~PM], plain[~PM], atol=1e-6, rtol=0)
    assert np.abs(got[PM] - plain[PM]).max() > 1e-4  # the switch matters


@pytest.mark.parametrize("pm", [PM, np.ones(4, bool), np.zeros(4, bool)],
                         ids=["mixed", "all_portrait", "all_landscape"])
def test_split_equals_select_with_masks(pm):
    """DropPath and head-dropout masks are per row, so each orientation
    group takes its rows' masks, and the split is the select."""
    cfg = port_cfg(_pm_cfg(train=False))
    cfg.MVIT.DROPPATH_RATE = 0.5
    cfg.MODEL.DROPOUT_RATE = 0.5
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=7)
    model.train()
    x = torch.randn(len(pm), cfg.DATA.NUM_FRAMES, *RECT, 3, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    masks = model.sample_drop_path_masks(len(pm), gen)
    dropout = model.sample_head_dropout_mask(len(pm), gen)
    with torch.no_grad():
        split = forward_by_orientation(model, x, pm if pm.any() else None, masks, dropout)
        land = model(x, drop_path_masks=masks, head_dropout_mask=dropout)
        port = model(x.transpose(2, 3), drop_path_masks=masks, head_dropout_mask=dropout,
                     hw_switch=True)
    select = torch.where(torch.from_numpy(pm)[:, None], port, land)
    np.testing.assert_allclose(to_np(split), to_np(select), atol=1e-6, rtol=0)
