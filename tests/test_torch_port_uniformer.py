"""The port's UniFormer and BatchNorm against the JAX package's.

At tiny width (EMBED_DIM [8, 16, 16, 32], DEPTH [1, 1, 1, 1], HEAD_DIM 8,
input [2, 4, 32, 32, 3], as tests/test_models.py builds it), float32 on the
CPU, with the same random parameters and BatchNorm statistics loaded into
both (``state_dict_from_jax`` of {"params", "batch_stats"}):

- each block (CBlock, SABlock, SplitSABlock) at eval, and in train mode
  with its BatchNorm running statistics;
- whole-model logits for the default model, SPLIT, FRAME_BASE and a rect
  48x32 input, the JAX side under ATTN_IMPL "batched" and "per_head"; the
  DPE of every block goes through ``ops.depthwise3x3x3``;
- train mode: logits and the updated running statistics against flax's
  ``mutable=["batch_stats"]``; ``frozen_stats`` (MODEL.FROZEN_BN);
- gradients of every parameter against ``jax.grad``;
- the parameter names, shapes and count of full UniFormer-S 16x4, the
  carry-over of ``batch_stats`` under ``strict=True``, and the weight-decay
  mask against JAX's ``make_wd_mask``.

Tolerance: atol 2e-4, rtol 1e-4 (running statistics rtol 1e-4).
"""

from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models import optimizer as joptim
from pmv_tpu.models import uniformer as juni
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.models import optimizer as optim
from pmv_tpu_torch.models import uniformer as puni
from pmv_tpu_torch.models.batchnorm import BatchNorm, frozen_stats
from pmv_tpu_torch.utils.weights import flax_path_to_torch, load_jax_params, state_dict_from_jax
from torch_port_util import (  # noqa: F401
    depthwise_calls,
    numpy_tree,
    port_cfg,
    random_batch_stats,
    random_params,
    to_np,
)

TOL = dict(atol=2e-4, rtol=1e-4)
UNIFORMER_S_PARAMS = 21_400_400


def tiny_cfg(split=False, frame_base=False, attn_impl="batched", rect=None):
    cfg = jax_get_cfg()
    cfg.MODEL.MODEL_NAME = "Uniformerframe" if frame_base else "Uniformer"
    cfg.MODEL.ARCH = "uniformer"
    cfg.MODEL.NUM_CLASSES = 7
    cfg.UNIFORMER.EMBED_DIM = [8, 16, 16, 32]
    cfg.UNIFORMER.DEPTH = [1, 1, 1, 1]
    cfg.UNIFORMER.HEAD_DIM = 8
    cfg.UNIFORMER.DROP_DEPTH_RATE = 0.0
    cfg.UNIFORMER.SPLIT = split
    cfg.UNIFORMER.FRAME_BASE = frame_base
    cfg.UNIFORMER.ATTN_IMPL = attn_impl
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    if rect:
        cfg.DATA.TRAIN_CROP_SIZE_RECT = list(rect)
    return cfg


def jax_variables(module, x, seed, **kwargs):
    """``module``'s variables at ``x``, every parameter and statistic redrawn
    with numpy from ``seed``."""
    v = module.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False, **kwargs)
    out = {"params": random_params(numpy_tree(v["params"]), seed)}
    if "batch_stats" in v:
        out["batch_stats"] = random_batch_stats(numpy_tree(v["batch_stats"]), seed + 1)
    return out


def _input(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _apply(module, variables, x, train):
    """(output, updated batch_stats or None) of a flax module."""
    if train and "batch_stats" in variables:
        out, upd = module.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        return out, upd["batch_stats"]
    return module.apply(variables, jnp.asarray(x), train=train), None


def _assert_stats(model, batch_stats):
    want = state_dict_from_jax({"params": {}, "batch_stats": batch_stats})
    got = model.state_dict()
    for name, value in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


BLOCKS = {
    "CBlock": (lambda: juni.CBlock(dim=8), lambda: puni.CBlock(8, 4.0, 0.0), (2, 2, 8, 8, 8)),
    "SABlock": (lambda: juni.SABlock(dim=16, num_heads=2),
                lambda: puni.SABlock(16, 2, 4.0, True, None, 0.0), (2, 2, 4, 4, 16)),
    "SplitSABlock": (lambda: juni.SplitSABlock(dim=16, num_heads=2),
                     lambda: puni.SplitSABlock(16, 2, 4.0, True, None, 0.0, (2, 4, 4)),
                     (2, 2, 4, 4, 16)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name, train, depthwise_calls):  # noqa: F811
    make_jax, make_port, shape = BLOCKS[name]
    x = _input(shape, 0)
    jblock = make_jax()
    variables = jax_variables(jblock, x, 1)
    want, new_stats = _apply(jblock, variables, x, train)

    block = make_port()
    load_jax_params(block, variables)
    block.train(train)
    got = block(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    assert depthwise_calls == [shape]  # the DPE, through ops.depthwise3x3x3
    if new_stats is not None:
        _assert_stats(block, new_stats)


MODELS = {
    "default": dict(),
    "split": dict(split=True),
    "frame_base": dict(frame_base=True),
    "rect_48x32": dict(rect=(48, 32)),
    "per_head": dict(attn_impl="per_head"),
    "split_per_head": dict(split=True, attn_impl="per_head"),
}


def _models(case, seed=2):
    cfg = tiny_cfg(**MODELS[case])
    h, w = MODELS[case].get("rect", (32, 32))
    x = _input((2, 4, h, w, 3), seed)
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    variables = jax_variables(jmodel, x, seed + 1)
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    load_jax_params(model, variables)
    return cfg, x, jmodel, variables, model


@pytest.mark.parametrize("case", sorted(MODELS))
def test_model_logits_match_jax(case, depthwise_calls):  # noqa: F811
    _, x, jmodel, variables, model = _models(case)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    model.eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 7)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    assert len(depthwise_calls) == 4  # one DPE per block

    jfeat = jmodel.apply(variables, jnp.asarray(x), train=False, return_features=True)
    with torch.inference_mode():
        feat = model(torch.from_numpy(x), return_features=True)
    assert feat.shape == jfeat.shape and feat.dim() == 5
    np.testing.assert_allclose(to_np(feat), np.asarray(jfeat), **TOL)


@pytest.mark.parametrize("case", ["default", "split"])
def test_train_mode_logits_and_running_stats_match_flax(case):
    _, x, jmodel, variables, model = _models(case, seed=4)
    want, new_stats = _apply(jmodel, variables, x, train=True)
    model.train()
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    _assert_stats(model, new_stats)
    assert int(model.norm.num_batches_tracked) == 1


def test_batchnorm_matches_flax_and_frozen_stats_hold_still():
    """Channels-last statistics over every other axis, the biased variance
    (also in the running update, where nn.BatchNorm3d takes the unbiased
    one: 0.4% apart at these 256 positions), momentum 0.9, eps 1e-5."""
    x = _input((2, 2, 8, 8, 8), 5) * 2.0 + 0.5
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": random_params(numpy_tree(v["params"]), 6),
                 "batch_stats": random_batch_stats(numpy_tree(v["batch_stats"]), 7)}
    want, upd = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    bn = BatchNorm(8)
    bn.load_state_dict(state_dict_from_jax(variables), strict=True)
    bn.train()
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    with frozen_stats(bn):
        frozen = bn(torch.from_numpy(x))
    assert all(torch.equal(before[k], v) for k, v in bn.state_dict().items())
    got = bn(torch.from_numpy(x))
    torch.testing.assert_close(frozen, got, rtol=0, atol=0)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    _assert_stats(bn, upd["batch_stats"])
    assert int(bn.num_batches_tracked) == 1 and bn.update_stats

    unbiased = torch.var(torch.from_numpy(x).reshape(-1, 8), dim=0, unbiased=True)
    biased = torch.var(torch.from_numpy(x).reshape(-1, 8), dim=0, unbiased=False)
    assert float((unbiased / biased - 1).min()) > 3e-3  # the trap is over the tolerance

    bn.eval()
    ev = bn(torch.from_numpy(x))
    jbn_ev = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    want_ev = jbn_ev.apply({"params": variables["params"], **upd}, jnp.asarray(x))
    np.testing.assert_allclose(to_np(ev), np.asarray(want_ev), **TOL)


@pytest.mark.parametrize("case", ["default", "split"])
def test_gradients_match_jax(case):
    cfg, x, jmodel, variables, model = _models(case, seed=8)
    g = _input((2, cfg.MODEL.NUM_CLASSES), 9)

    def loss(params):
        out, _ = jmodel.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        return jnp.sum(out * g)

    jgrads = state_dict_from_jax(numpy_tree(jax.grad(loss)(variables["params"])))
    model.train()
    (model(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    # Against the largest gradient: what feeds a BatchNorm in train mode only
    # as a per-channel shift (the bias of the last block's fc2) has a true
    # gradient of 0 and float noise in both.
    scale = max(float(g.abs().max()) for g in jgrads.values())
    for name, want in jgrads.items():
        np.testing.assert_allclose(grads[name].numpy() / scale, want.numpy() / scale,
                                   atol=2e-5, rtol=0, err_msg=name)


def test_full_uniformer_s_state_dict_matches_jax_tree():
    """Names, shapes and count at full width from jax.eval_shape of the JAX
    init (nothing run at full size); 21.4M parameters in both."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parents[1] / "configs" / "Kinetics"
                            / "UNIFORMER_S_16x4.yaml"))
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    x = jax.ShapeDtypeStruct((1, 16, 224, 224, 3), jnp.float32)
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False), x)
    expected = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes[collection])[0]:
            names = [str(k.key) for k in path]
            shape = tuple(leaf.shape)
            if names[-1] == "kernel":
                shape = {5: lambda s: (s[4], s[3], *s[:3]), 2: lambda s: s[::-1]}[len(shape)](shape)
            expected[flax_path_to_torch(names)] = shape
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))

    with torch.device("meta"):
        model = puni.Uniformer(port_cfg(cfg))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == expected
    assert sum(p.numel() for p in model.parameters()) == n_jax == UNIFORMER_S_PARAMS
    # 3 + 4 CBlocks with two BatchNorms each, and the final norm.
    assert sum(isinstance(m, BatchNorm) for m in model.modules()) == 15


def test_batch_stats_carry_over_strictly():
    _, x, _, variables, model = _models("default")
    state = state_dict_from_jax(variables)
    assert state["blocks1.0.norm1.running_var"].shape == (8,)
    assert int(state["norm.num_batches_tracked"]) == 0
    model.load_state_dict(state, strict=True)
    with pytest.raises(RuntimeError, match="running_mean"):
        model.load_state_dict(state_dict_from_jax(variables["params"]), strict=True)


def test_weight_decay_mask_matches_jax():
    """The ``pos_embed`` rule takes the DPE weights out of weight decay
    (MVIT.ZERO_DECAY_POS_CLS, on by default); BatchNorm and LayerNorm
    weights fall under ZERO_WD_1D_PARAM."""
    cfg, _, _, variables, model = _models("split")
    cfg.SOLVER.ZERO_WD_1D_PARAM = True
    want = {flax_path_to_torch([str(k.key) for k in path]): bool(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                joptim.make_wd_mask(variables["params"], cfg))[0]}
    got = optim.make_wd_mask(model, port_cfg(cfg))
    assert got == want
    assert not got["blocks1.0.pos_embed.weight"] and got["blocks1.0.conv1.weight"]
    assert not got["blocks1.0.norm1.weight"] and not got["norm.weight"]


def test_temporal_attention_init_and_dropout_refusal():
    cfg = port_cfg(tiny_cfg(split=True))
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=1)
    t_attn = model.blocks3[0].t_attn
    assert not t_attn.qkv.weight.any() and bool((t_attn.proj.weight == 1).all())
    assert model.sample_head_dropout_mask(2, torch.Generator()) is None
    cfg.UNIFORMER.DROPOUT_RATE = 0.1
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    x = torch.zeros(1, 4, 32, 32, 3)
    with torch.inference_mode():
        model.eval()(x)  # eval: dropout is the identity
    # Training takes the keep masks that the train step draws
    # (tests/test_torch_port_dropout_pool_first.py holds them against JAX).
    with pytest.raises(ValueError, match="keep mask"):
        model.train()(x)
    model.train()(x, dropout_masks=model.sample_dropout_masks(x.shape, torch.Generator()))


def test_split_drop_path_masks_are_per_site_and_frame():
    """SplitSABlock drops its temporal branch per (clip, site) and its
    spatial one per (clip, frame), on the train crop's grid."""
    cfg = port_cfg(tiny_cfg(split=True))
    cfg.UNIFORMER.DROP_DEPTH_RATE = 0.3
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    masks = model.sample_drop_path_masks(2, torch.Generator().manual_seed(0))
    assert masks[0] is None  # the first block's rate is 0
    assert [m.shape[0] for m in masks[2]] == [2 * 2 * 2, 2 * 2, 2]  # grid (2, 2, 2)
    assert [m.shape[0] for m in masks[3]] == [2 * 1 * 1, 2 * 2, 2]
    model.train()
    out = model(torch.randn(2, 4, 32, 32, 3), drop_path_masks=masks)
    assert torch.isfinite(out).all()
