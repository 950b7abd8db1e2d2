"""MVIT.POOL_FIRST, and MViT's and UniFormer's dropouts in training, against
the JAX package's train step.

- POOL_FIRST on tiny MViT (4 frames, width 8, block 0's stride-1 3x3x3
  q-pool on K1's plain version; the pools at the block's input width, the
  q/k/v linears after them): two train steps against the jitted JAX
  ``make_train_step`` fed the same draws, at JAX's defaults and under
  ``apply_bench_recipe`` (its FLAT_POOLS and ATTN_Q_CHUNK, which POOL_FIRST
  leaves aside; the preprocessing in float32 and the default PRNG, as
  tests/test_torch_port_mvit.py runs the recipe): loss and grad norm to
  rtol 1e-5, top-1/top-5 equal, parameters to atol 1e-5 after two AdamW
  steps of lr 1e-3 (but the few whose gradient is float noise, as
  ``_assert_params`` says); the eval scores after them to atol 2e-4, rtol
  1e-4.
- MVIT.DROPOUT_RATE 0.3 (the embedding's, each attention projection's and
  each MLP's two) with the head's at 0.5, in the POOL_FIRST case at JAX's
  defaults, and UniFormer's UNIFORMER.DROPOUT_RATE 0.2 and
  ATTENTION_DROPOUT_RATE 0.2 (global and split attention): the same two
  steps, the port fed the keep masks the JAX step draws
  (``jax_model_dropout_masks``, read off its modules under the step's
  dropout key), with the gates above (UniFormer's as
  tests/test_torch_port_uniformer_train.py holds its steps).
- ``sample_dropout_masks``: every mask keeps its rate's share (a
  binomial bound of 6 sigma), the shapes the JAX package's, seeds give
  other masks, rate 0 draws none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_train as mvit_train
import test_torch_port_uniformer_train as uni_train
from __graft_entry__ import apply_bench_recipe
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine.train_state import TrainState
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models import optimizer as joptim
from pmv_tpu_torch.engine.steps import init_state, make_eval_step, make_train_step
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax
from torch_port_util import (  # noqa: F401
    depthwise_calls,
    jax_dropout_key,
    jax_model_dropout_masks,
    jax_train_draws,
    numpy_tree,
    port_cfg,
    random_batch_stats,
    random_params,
    to_np,
)

LRS = (1e-3, 7e-4)


def _mvit_cfg(recipe=False, pool_first=False, dropout=0.0):
    cfg = mvit_train._train_cfg()
    cfg.MVIT.POOL_FIRST = pool_first
    cfg.MVIT.DROPOUT_RATE = dropout
    if dropout:
        cfg.MODEL.DROPOUT_RATE = 0.5
    if recipe:
        apply_bench_recipe(cfg)
        cfg.AUG.AA_TYPE = "rand-m7-n1-mstd0.5-inc1"
        cfg.TPU.PREPROCESS_DTYPE = "float32"
        cfg.TPU.PRNG_IMPL = ""
    return cfg


def _jax_state(cfg, batch, seed=4):
    """The JAX model and a train state of numpy draws on its tree, which
    ``jax.eval_shape`` gives without compiling the init."""
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros(batch["frames"].shape), train=False))
    params = random_params(shapes["params"], seed)
    stats = random_batch_stats(shapes.get("batch_stats", {}), seed + 1)
    tx = joptim.construct_optimizer(params, cfg)
    return jmodel, TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                              opt_state=tx.init(params)), tx


def _steps(cfg, jmodel, jstate, tx, model, batches, rng, dropout):
    """A JAX step and a port step on the same draws (and, with ``dropout``,
    JAX's keep masks) for each batch; the metrics compared at each."""
    jstep = jax.jit(jsteps.make_train_step(cfg, jmodel, tx))
    pcfg = port_cfg(cfg)
    state = init_state(pcfg, model)
    step = make_train_step(pcfg, device="cpu")
    for i, (batch, lr) in enumerate(zip(batches, LRS)):
        variables = {"params": jstate.params}
        if jstate.batch_stats:
            variables["batch_stats"] = jstate.batch_stats
        draws = jax_train_draws(cfg, rng, i, batch["frames"].shape)
        if dropout:
            x = np.zeros(batch["frames"].shape, np.float32)
            draws["dropout_masks"], head = jax_model_dropout_masks(
                jmodel, variables, x, jax_dropout_key(rng, i), model)
            if head is not None:
                draws["dropout"] = head
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng, lr)
        m = step(state, batch, lr, draws)
        assert not bool(m["nan"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        assert float(m["top1_err"]) == float(jm["top1_err"])
        assert float(m["top5_err"]) == float(jm["top5_err"])
    return jstate


def _assert_params(model, jstate):
    """Parameters to atol 1e-5, but for the few elements whose gradient is
    near float noise, which Adam's first steps (about lr x sign(g)) may
    move either way: those within 2 x the summed LRs, and no more than 1e-3
    of the elements (``test_torch_port_uniformer_train._assert_state_matches``'s
    rule)."""
    ref = state_dict_from_jax(numpy_tree(jstate.params))
    got = model.state_dict()
    n_off = n = 0
    for name, value in ref.items():
        if name.endswith("norm_k.bias") or name.endswith("k.bias"):
            # Softmax ignores a shift along the keys: the keys' LayerNorm bias
            # and, under POOL_FIRST, the k linear's bias have a gradient of
            # float noise, which Adam scales to +-lr.
            continue
        a, b = got[name].numpy(), value.numpy()
        np.testing.assert_allclose(a, b, atol=2.0001 * sum(LRS), rtol=0, err_msg=name)
        n_off += int((np.abs(a - b) > 1e-5).sum())
        n += a.size
    assert n_off <= 1e-3 * n, f"{n_off} of {n} weights off by more than 1e-5"


@pytest.mark.parametrize("recipe", ["defaults", "bench_recipe"])
def test_pool_first_train_steps_match_jax(recipe, depthwise_calls):  # noqa: F811
    """At JAX's defaults with MViT's dropouts on, JAX's masks fed to the port;
    under the recipe without them."""
    defaults = recipe == "defaults"
    cfg = _mvit_cfg(recipe=not defaults, pool_first=True, dropout=0.3 if defaults else 0.0)
    batches = [mvit_train._batch(cfg, 2, seed) for seed in (0, 1)]
    jmodel, jstate, tx = _jax_state(cfg, batches[0])
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    load_jax_params(model, jstate.params)
    assert {"blocks.0.attn.q.weight", "blocks.1.attn.v.bias"} <= set(model.state_dict())
    # Block 0 pools at width 8 (its input), block 1's K/V pools at 8 too
    # (dim_out 16): the pool kernels and norms are the input's head width.
    assert tuple(model.blocks[1].attn.pool_k.weight.shape) == (4, 1, 3, 3, 3)
    jstate = _steps(cfg, jmodel, jstate, tx, model, batches, jax.random.PRNGKey(3), defaults)
    # Each forward: block 0's q-pool, block 1's K and V pools, on K1's path.
    assert len(depthwise_calls) == 6
    _assert_params(model, jstate)
    frames = batches[0]["frames"]
    want = jax.jit(jsteps.make_eval_step(cfg, jmodel))(jstate, frames)
    got = make_eval_step(port_cfg(cfg), model, device="cpu")(frames)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("split", [False, True], ids=["global", "split"])
def test_uniformer_dropout_train_steps_match_jax(split):
    cfg = uni_train._train_cfg()
    cfg.UNIFORMER.SPLIT = split
    cfg.UNIFORMER.DROPOUT_RATE = 0.2
    cfg.UNIFORMER.ATTENTION_DROPOUT_RATE = 0.2
    batches = [uni_train._batch(cfg, seed) for seed in (0, 1)]
    jmodel, jstate, tx = _jax_state(cfg, batches[0])
    _, model = uni_train._port(cfg, jstate)
    jstate = _steps(cfg, jmodel, jstate, tx, model, batches, jax.random.PRNGKey(3), True)
    uni_train._assert_state_matches(model, jstate, LRS)


def _leaves(masks):
    if masks is None:
        return []
    if isinstance(masks, (list, tuple)):
        return [leaf for m in masks for leaf in _leaves(m)]
    return [masks]


@pytest.mark.parametrize("name", ["mvit", "uniformer"])
def test_dropout_masks_keep_their_rate(name):
    if name == "mvit":
        cfg = port_cfg(_mvit_cfg(dropout=0.3))
        shape, rate = (4, 4, 16, 16, 3), 0.3
    else:
        cfg = port_cfg(uni_train._train_cfg())
        cfg.UNIFORMER.DROPOUT_RATE = cfg.UNIFORMER.ATTENTION_DROPOUT_RATE = 0.3
        shape, rate = (4, 4, 64, 64, 3), 0.3
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    masks = _leaves(model.sample_dropout_masks(shape, torch.Generator().manual_seed(0)))
    assert masks and all(m.shape[0] % shape[0] == 0 for m in masks)
    ones = sum(float(m.sum()) for m in masks)
    n = sum(m.numel() for m in masks)
    assert set(torch.cat([m.flatten() for m in masks]).unique().tolist()) == {0.0, 1.0}
    assert abs(ones / n - (1 - rate)) < 6 * (rate * (1 - rate) / n) ** 0.5
    other = _leaves(model.sample_dropout_masks(shape, torch.Generator().manual_seed(1)))
    assert any(not torch.equal(a, b) for a, b in zip(masks, other))
    if name == "mvit":
        cfg.MVIT.DROPOUT_RATE = 0.0
    else:
        cfg.UNIFORMER.DROPOUT_RATE = cfg.UNIFORMER.ATTENTION_DROPOUT_RATE = 0.0
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    assert model.sample_dropout_masks(shape, torch.Generator()) is None
