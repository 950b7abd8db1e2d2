"""The port's MViT eval path against the JAX package's.

- The whole eval step at tiny width (uint8 -> normalize -> MViT -> softmax)
  against JAX ``make_eval_step``, with block 0's q-pool at stride 1 and
  kernel 3x3x3 so that the depthwise path is taken; JAX both at its
  defaults and under ``apply_bench_recipe``. Softmax outputs to atol 2e-5,
  ``return_features`` tokens to atol 2e-4 / rtol 1e-4 (float32 on the CPU).
- The full MViTv2-S 16x4 parameter names, shapes and count, without
  running it (``jax.eval_shape``; the port's model built on the meta
  device).
- The entry points refuse to run without CUDA unless asked for the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from __graft_entry__ import _mvitv2_s_cfg, apply_bench_recipe
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.utils import torch_import
from pmv_tpu_torch.engine.steps import make_eval_step
from pmv_tpu_torch.entry import mvitv2_s_cfg
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.models.mvit import MViT
from pmv_tpu_torch.utils.weights import flax_path_to_torch, load_jax_params
from torch_port_util import depthwise_calls, numpy_tree, port_cfg, to_np  # noqa: F401

MVITV2_S_PARAMS = 34_537_744


def _tiny_cfg(recipe, portrait=False):
    cfg = _mvitv2_s_cfg(tiny=True)
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.EMBED_DIM = 16
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]  # block 0: stride-1 3x3x3 q-pool
    cfg.TEST.PROCESS = True
    if portrait:
        cfg.DATA.TEST_CROP_SIZE_RECT = [24, 16]
        cfg.DATA.TRAIN_CROP_SIZE_RECT_SWITCH_AUTO = True
    if recipe:
        apply_bench_recipe(cfg)
        cfg.TPU.PREPROCESS_DTYPE = "float32"
    return cfg


def _frames(cfg, b, seed):
    from pmv_tpu_torch.models.mvit import geometry

    t, h, w = geometry(cfg)
    return np.random.default_rng(seed).integers(0, 256, (b, t, h, w, 3), np.uint8)


@pytest.mark.parametrize("case", ["defaults", "bench_recipe", "portrait"])
def test_tiny_eval_step_matches_jax(case, depthwise_calls):  # noqa: F811
    cfg = _tiny_cfg(recipe=case == "bench_recipe", portrait=case == "portrait")
    frames = _frames(cfg, 2, seed=0)
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    state, _ = jsteps.init_state(
        cfg, jmodel,
        {"frames": jnp.asarray(frames), "labels": jnp.zeros((2,), jnp.int32)},
        jax.random.PRNGKey(0),
    )
    jpreds = np.asarray(jax.jit(jsteps.make_eval_step(cfg, jmodel))(state, frames))
    x = jsteps.make_eval_preprocess_fn(cfg)(jnp.asarray(frames))
    jfeat, jthw = jmodel.apply(
        {"params": state.params}, x, train=False, return_features=True
    )

    pcfg = port_cfg(cfg)
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    load_jax_params(model, numpy_tree(state.params))
    preds = make_eval_step(pcfg, model, device="cpu")(frames)

    assert preds.shape == (2, cfg.MODEL.NUM_CLASSES)
    np.testing.assert_allclose(to_np(preds), jpreds, atol=2e-5, rtol=0)
    # Block 0's q-pool, and block 1's K and V pools (adaptive KV stride 1).
    assert len(depthwise_calls) == 3

    with torch.inference_mode():
        feat, thw = model(torch.tensor(np.asarray(x)), return_features=True)
    assert tuple(thw) == tuple(jthw)
    np.testing.assert_allclose(to_np(feat), np.asarray(jfeat), atol=2e-4, rtol=1e-4)


def test_full_mvitv2_s_state_dict_matches_jax_param_tree():
    """Names and shapes at full width, from jax.eval_shape of the JAX init;
    nothing is allocated or run at full size."""
    cfg = _mvitv2_s_cfg()
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    x = jax.ShapeDtypeStruct((1, 16, 224, 224, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False), x
    )["params"]
    expected = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [str(k.key) for k in path]
        shape = tuple(leaf.shape)
        if names[-1] in ("kernel", "pool_kernel"):
            shape = {5: lambda s: (s[4], s[3], *s[:3]), 2: lambda s: s[::-1]}[
                len(shape)
            ](shape)
        expected[flax_path_to_torch(names)] = shape
        assert flax_path_to_torch(names) == torch_import._flax_path_to_torch(names)

    with torch.device("meta"):
        model = MViT(port_cfg(cfg))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == expected
    assert sum(int(np.prod(s)) for s in got.values()) == MVITV2_S_PARAMS


@pytest.mark.parametrize("tiny", [False, True])
def test_port_entry_cfg_matches_graft_entry(tiny):
    assert yaml.safe_load(mvitv2_s_cfg(tiny).dump()) == yaml.safe_load(
        _mvitv2_s_cfg(tiny).dump()
    )


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = mvitv2_s_cfg(tiny=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert next(model.parameters()).dtype == torch.float32
    assert model.compute_dtype == torch.bfloat16  # compute_dtype(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(cfg, model)
    preds = make_eval_step(cfg, model, device="cpu")(_frames(cfg, 1, seed=1))
    assert preds.dtype == torch.float32
    torch.testing.assert_close(preds.sum(dim=1), torch.ones(1))


def test_seeded_init_is_reproducible():
    cfg = mvitv2_s_cfg(tiny=True)
    a = build_model(cfg, device="cpu", seed=3).state_dict()
    b = build_model(cfg, device="cpu", seed=3).state_dict()
    c = build_model(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["cls_token"], c["cls_token"])
