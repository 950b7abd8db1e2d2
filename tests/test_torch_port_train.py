"""The port's train step and train_epoch against the JAX package's.

- One whole train step, then a second, at tiny MViT width with 4 frames and
  POOL_KVQ_KERNEL [3, 3, 3], so that the depthwise path runs forward and
  backward: RandAugment (one layer, per-clip chains), normalize, random
  erasing, MixUp/CutMix, soft cross-entropy, backward, clip and AdamW,
  against the jitted JAX ``make_train_step`` from the same parameters and
  the same draws (repeated from the JAX keys by torch_port_util). DropPath
  and the head's dropout are 0, since flax draws their masks from module RNG
  streams (tests/test_torch_port_augment.py holds both against JAX on the
  same masks). float32 on the
  CPU: loss and grad norm to rtol 1e-5, top-1/top-5 equal, parameters to
  atol 1e-5 after the two AdamW steps of lr 1e-3.
- ``train_epoch`` for 3 iterations with a flush every 2: the per-iteration
  LRs (warmup into cosine) and the TrainMeter's json_stats equal JAX's
  ``train_epoch`` fed the same metrics; an injected NaN raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from __graft_entry__ import _mvitv2_s_cfg, apply_bench_recipe
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine import train as jtrain
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.parallel import mesh as mesh_lib
from pmv_tpu.utils import logging as jlogging
from pmv_tpu.utils import meters as jmeters
from pmv_tpu_torch.engine.steps import init_state, make_train_step
from pmv_tpu_torch.engine.train import train_epoch
from pmv_tpu_torch.entry import apply_bench_recipe as port_bench_recipe
from pmv_tpu_torch.entry import mvitv2_s_cfg
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.utils import logging as port_logging
from pmv_tpu_torch.utils import meters
from pmv_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax
from torch_port_util import depthwise_calls, jax_train_draws, port_cfg, random_params  # noqa: F401


def _train_cfg():
    cfg = _mvitv2_s_cfg(tiny=True)
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]  # block 0: stride-1 3x3x3 q-pool
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.AUG.ENABLE = True
    cfg.AUG.AA_TYPE = "rand-m7-n1-mstd0.5-inc1"
    cfg.AUG.RE_PROB = 0.75
    cfg.SOLVER.BASE_LR = 1e-3
    cfg.TPU.DEVICE_PREFETCH = 0
    return cfg


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (b, cfg.DATA.NUM_FRAMES, 16, 16, 3), np.uint8)
    labels = rng.integers(0, cfg.MODEL.NUM_CLASSES, b)
    return {"frames": frames, "labels": labels}


def test_tiny_train_step_matches_jax(depthwise_calls):  # noqa: F811
    cfg = _train_cfg()
    batches = [_batch(cfg, 2, seed) for seed in (0, 1)]
    rng = jax.random.PRNGKey(3)
    lrs = [1e-3, 7e-4]

    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jstate, tx = jsteps.init_state(cfg, jmodel, jbatch, jax.random.PRNGKey(0))
    params = random_params(jax.tree_util.tree_map(np.asarray, jstate.params), 4)
    jstate = jstate.replace(params=params, opt_state=tx.init(params))
    jstep = jax.jit(jsteps.make_train_step(cfg, jmodel, tx))

    pcfg = port_cfg(cfg)
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    load_jax_params(model, params)
    state = init_state(pcfg, model)
    step = make_train_step(pcfg, device="cpu")

    for i, (batch, lr) in enumerate(zip(batches, lrs)):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jstate, jm = jstep(jstate, jbatch, rng, lr)
        draws = jax_train_draws(cfg, rng, i, batch["frames"].shape)
        m = step(state, batch, lr, draws)
        assert set(m) == set(jm) and not bool(m["nan"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        assert float(m["top1_err"]) == float(jm["top1_err"])
        assert float(m["top5_err"]) == float(jm["top5_err"])
    assert state.step == int(jstate.step) == 2
    # Each forward: block 0's q-pool and block 1's K and V pools.
    assert len(depthwise_calls) == 6

    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = model.state_dict()
    for name, value in ref.items():
        if name.endswith("norm_k.bias"):
            # The loss does not depend on the keys' LayerNorm bias (softmax
            # is shift-invariant along the keys): its gradient is float
            # noise of order 1e-8 in both, which Adam scales to +-lr.
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


def test_bench_recipe_matches_graft_entry_but_tpu_layouts():
    """The port's recipe sets what the JAX one sets, but the TPU.* keys and
    MVIT.FLAT_POOLS, which choose TPU layouts."""
    ref = apply_bench_recipe(_mvitv2_s_cfg())
    ref.TPU = _mvitv2_s_cfg().TPU
    ref.MVIT.FLAT_POOLS = False
    got = port_bench_recipe(mvitv2_s_cfg())
    assert got.AUG.AA_TYPE == "rand-m7-n4-mstd0.5-inc1" and got.AUG.RE_PROB == 0.25
    assert yaml.safe_load(got.dump()) == yaml.safe_load(ref.dump())


def test_train_step_modes_and_refusals():
    cfg = port_cfg(_train_cfg())
    cfg.MVIT.DROPPATH_RATE = 0.3
    cfg.MODEL.DROPOUT_RATE = 0.5
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    state = init_state(cfg, model)
    step = make_train_step(cfg, device="cpu", seed=5)
    m = step(state, _batch(cfg, 2, 0), 1e-3)  # draws its own masks
    assert model.training and np.isfinite(float(m["loss"]))
    # The same step takes a batch with a portrait (pm) row.
    m = step(state, dict(_batch(cfg, 2, 1), pm=np.array([True, False])), 1e-3)
    assert state.step == 2 and np.isfinite(float(m["loss"]))


def _epoch_cfg():
    cfg = _train_cfg()
    cfg.AUG.ENABLE = False
    cfg.LOG_PERIOD = 2
    cfg.SOLVER.MAX_EPOCH = 3
    cfg.SOLVER.WARMUP_EPOCHS = 1.5
    cfg.SOLVER.WARMUP_START_LR = 1e-5
    return cfg


def _recorder(monkeypatch, module):
    logged = []
    monkeypatch.setattr(module, "log_json_stats", lambda stats, logger=None: logged.append(stats))
    return logged


_TIMING = ("dt", "dt_data", "dt_net", "eta")


def test_train_epoch_matches_jax(monkeypatch):
    cfg = _epoch_cfg()
    pcfg = port_cfg(cfg)
    loader = [_batch(cfg, 2, seed) for seed in range(3)]
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    state = init_state(pcfg, model)
    step = make_train_step(pcfg, device="cpu")
    seen = []

    def recording_step(state, batch, lr):
        metrics = step(state, batch, lr)
        seen.append((lr, {k: np.asarray(v) for k, v in metrics.items()}))
        return metrics

    logged = _recorder(monkeypatch, port_logging)
    train_epoch(loader, recording_step, state, meters.TrainMeter(3, pcfg), 1, pcfg)
    assert state.step == 3

    jseen = iter(seen)
    jlrs = []

    def jax_step(state, batch, rng, lr):
        jlrs.append(lr)
        return state, next(jseen)[1]

    jlogged = _recorder(monkeypatch, jlogging)
    jloader = [dict(b, pm=np.zeros(2, bool)) for b in loader]
    mesh = mesh_lib.create_mesh(devices=jax.devices()[:1])
    jtrain.train_epoch(jloader, jax_step, jax_step, None, jmeters.TrainMeter(3, cfg),
                       1, cfg, mesh, None)

    assert [lr for lr, _ in seen] == jlrs and len(set(jlrs)) == 3
    assert len(logged) == len(jlogged) == 2  # iteration 2, then the epoch
    for ours, ref in zip(logged, jlogged):
        assert {k: v for k, v in ours.items() if k not in _TIMING} == {
            k: v for k, v in ref.items() if k not in _TIMING
        }


def test_train_epoch_nan_guard_raises(monkeypatch):
    cfg = port_cfg(_epoch_cfg())
    loader = [_batch(cfg, 2, seed) for seed in range(3)]
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    state = init_state(cfg, model)
    step = make_train_step(cfg, device="cpu")

    def poisoned(state, batch, lr):
        metrics = step(state, batch, lr)
        if state.step == 2:
            metrics["nan"] = torch.tensor(True)
        return metrics

    _recorder(monkeypatch, port_logging)
    with pytest.raises(RuntimeError, match="NaN losses at iter 1"):
        train_epoch(loader, poisoned, state, meters.TrainMeter(3, cfg), 0, cfg)
