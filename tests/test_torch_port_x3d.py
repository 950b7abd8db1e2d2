"""The port's X3D against the JAX package's.

On configs/tiny_x3d_synthetic.yaml, loaded with ``--opts``-style overrides
(``merge_from_list``), not edited: its DEPTH_FACTOR 0.2 gives one strided
block a stage, so no stride-1 channelwise conv; at DEPTH_FACTOR 1.0 its
[1, 2, 5, 3] blocks put 7 channelwise convs on K1's path. Inputs [2, 4, 64,
64, 3] (rect: 64 x 48), float32 on the CPU, the same parameters and
BatchNorm statistics in both (the JAX init, with every BatchNorm's scale,
bias and statistics, every bias and the projection redrawn with numpy, so
that the norms and the head move the outputs):

- ``SE``, ``X3DTransform`` (with and without SE), ``ResBlock`` (stride 1
  and 2), ``X3DStem`` and ``X3DHead`` (with and without BN_LIN5) one by
  one, at eval and in train mode with their running statistics;
- the eval scores and features of the model, and K1 called once a forward
  per stride-1 channelwise conv (a spy on ``ops.depthwise3x3x3``);
- a train-mode forward's logits and running statistics, with the head's
  dropout mask read off the JAX model (``jax_dropout_masks``);
- the gradients of every parameter against ``jax.grad``;
- ``make_wd_mask`` on X3D's names against JAX's;
- full-width X3D-M: the state_dict against the JAX tree from
  ``jax.eval_shape`` (names, shapes, count, a strict load), and the init's
  standard deviation per kind of weight within 10% of the JAX init's.

Tolerance: atol 2e-4, rtol 1e-4 (running statistics rtol 1e-4, atol 1e-6).
"""

import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models import heads as jheads
from pmv_tpu.models import optimizer as joptim
from pmv_tpu.models import resnet_helper as jrh
from pmv_tpu.models import stem as jstem
from pmv_tpu.models.batchnorm import get_norm as jax_get_norm
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.models import heads as pheads
from pmv_tpu_torch.models import optimizer as optim
from pmv_tpu_torch.models import resnet_helper as prh
from pmv_tpu_torch.models import stem as pstem
from pmv_tpu_torch.models import x3d as px3d
from pmv_tpu_torch.models.batchnorm import BatchNorm, get_norm
from pmv_tpu_torch.utils.weights import flax_path_to_torch, load_jax_params, state_dict_from_jax
from torch_port_util import (  # noqa: F401
    depthwise_calls,
    jax_dropout_masks,
    numpy_tree,
    port_cfg,
    random_batch_stats,
    to_np,
)

ROOT = Path(__file__).resolve().parents[1]
TINY_X3D = str(ROOT / "configs" / "tiny_x3d_synthetic.yaml")
X3D_M = str(ROOT / "configs" / "Kinetics" / "X3D_M.yaml")
TOL = dict(atol=2e-4, rtol=1e-4)


def tiny_x3d_cfg(*opts):
    """configs/tiny_x3d_synthetic.yaml with ``opts`` (KEY VALUE ...) over it."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(TINY_X3D)
    cfg.merge_from_list(list(opts))
    return cfg


DEPTH_1 = ("X3D.DEPTH_FACTOR", "1.0")


def x3d_params(params, seed):
    """The JAX init with every BatchNorm scale near 1, every bias, and the
    projection's kernel redrawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)

    def draw(path, p):
        names = [str(k.key) for k in path]
        if names[-1] == "scale":
            return (1.0 + 0.1 * rng.normal(size=p.shape)).astype(np.float32)
        if names[-1] == "bias":
            return (0.1 * rng.normal(size=p.shape)).astype(np.float32)
        if "projection" in names:
            return (0.3 * rng.normal(size=p.shape)).astype(np.float32)
        return np.asarray(p)

    return jax.tree_util.tree_map_with_path(draw, numpy_tree(params))


def jax_variables(module, x, seed, **kwargs):
    v = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False, **kwargs)
    out = {"params": x3d_params(v["params"], seed)}
    if "batch_stats" in v:
        out["batch_stats"] = random_batch_stats(numpy_tree(v["batch_stats"]), seed + 1)
    return out


def _input(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _assert_stats(model, batch_stats):
    want = state_dict_from_jax({"params": {}, "batch_stats": batch_stats})
    got = model.state_dict()
    for name, value in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


JNORM = partial(jax_get_norm(tiny_x3d_cfg()), dtype=jnp.float32)


def _transform(jax_cls, port_cls, block_idx, stride=1, dim_out=16):
    kw = dict(temp_kernel_size=3, stride=stride, dim_inner=24, num_groups=24,
              stride_1x1=False, dilation=1)
    return (lambda: jax_cls(dim_out=dim_out, norm=JNORM, block_idx=block_idx, **kw),
            lambda: port_cls(16, dim_out, norm=BatchNorm, block_idx=block_idx, **kw))


def _resblock(stride, dim_out):
    kw = dict(temp_kernel_size=3, stride=stride, trans_func_name="x3d_transform",
              dim_inner=24, num_groups=24, stride_1x1=False, dilation=1, block_idx=0)
    return (lambda: jrh.ResBlock(dim_in=16, dim_out=dim_out, norm=JNORM, **kw),
            lambda: prh.ResBlock(16, dim_out, norm=BatchNorm, **kw))


def _head(bn_lin5):
    kw = dict(num_classes=5, dropout_rate=0.0, act_func="softmax", bn_lin5_on=bn_lin5)
    return (lambda: jheads.X3DHead(dim_inner=24, dim_out=32, **kw),
            lambda: pheads.X3DHead(16, 24, 32, **kw))


# name -> (JAX module, port module, input shape, K1 calls a forward)
MODULES = {
    "SE": (lambda: jrh.SE(dim_in=16, ratio=0.0625), lambda: prh.SE(16, 0.0625),
           (2, 2, 4, 4, 16), 0),
    "X3DTransform_se": (*_transform(jrh.X3DTransform, prh.X3DTransform, 0),
                        (2, 3, 6, 6, 16), 1),
    "X3DTransform_no_se": (*_transform(jrh.X3DTransform, prh.X3DTransform, 1),
                           (2, 3, 6, 6, 16), 1),
    "ResBlock_stride1": (*_resblock(1, 16), (2, 3, 6, 6, 16), 1),
    "ResBlock_stride2": (*_resblock(2, 24), (2, 3, 7, 6, 16), 0),
    "X3DStem": (lambda: jstem.X3DStem(dim_out=12, kernel=(5, 3, 3), stride=(1, 2, 2),
                                      padding=(2, 1, 1)),
                lambda: pstem.X3DStem(3, 12, (5, 3, 3), (1, 2, 2), (2, 1, 1)),
                (2, 6, 15, 16, 3), 0),
    "X3DHead": (*_head(False), (4, 2, 3, 3, 16), 0),
    "X3DHead_bn_lin5": (*_head(True), (4, 2, 3, 3, 16), 0),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, train, depthwise_calls):  # noqa: F811
    make_jax, make_port, shape, k1 = MODULES[name]
    x = _input(shape, 0)
    jmod = make_jax()
    kwargs = {} if name == "SE" else {"train": False}
    v = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), **kwargs)
    variables = {"params": x3d_params(v["params"], 1)}
    if "batch_stats" in v:
        variables["batch_stats"] = random_batch_stats(numpy_tree(v["batch_stats"]), 2)
    new_stats = None
    if name == "SE":
        want = jmod.apply(variables, jnp.asarray(x))
    elif train:
        want, upd = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        new_stats = upd["batch_stats"]
    else:
        want = jmod.apply(variables, jnp.asarray(x), train=False)

    module = make_port()
    load_jax_params(module, variables)
    module.train(train)
    got = module(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    assert len(depthwise_calls) == k1
    if new_stats is not None:
        _assert_stats(module, new_stats)


def test_se_sits_on_every_other_block():
    cfg = port_cfg(tiny_x3d_cfg(*DEPTH_1))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    se = [b.branch2.se is not None for s in model.stages() for b in s.blocks()]
    assert se == [True, True, False, True, False, True, False, True, True, False, True]


MODELS = {
    "tiny": ((), (64, 64), 0),
    "depth1": (DEPTH_1, (64, 64), 7),
    "depth1_rect": (DEPTH_1, (64, 48), 7),
}


def _models(case, seed=2, batch=2):
    opts, (h, w), _ = MODELS[case]
    cfg = tiny_x3d_cfg(*opts)
    x = _input((batch, 4, h, w, 3), seed)
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    variables = jax_variables(jmodel, x, seed + 1)
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    load_jax_params(model, variables)
    return cfg, x, jmodel, variables, model


@pytest.mark.parametrize("case", sorted(MODELS))
def test_eval_scores_and_features_match_jax(case, depthwise_calls):  # noqa: F811
    _, x, jmodel, variables, model = _models(case)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    model.eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 5)
    assert float(want.max()) < 0.99  # scores, not a saturated softmax
    np.testing.assert_allclose(to_np(got), want, **TOL)
    # One K1 call per stride-1 channelwise conv: 0 at DEPTH_FACTOR 0.2, and
    # 1 + 4 + 2 in stages 3-5 at 1.0 (inner widths 24, 48 and 96).
    n_k1 = MODELS[case][2]
    assert len(depthwise_calls) == n_k1
    assert sorted({s[-1] for s in depthwise_calls}) == ([24, 48, 96] if n_k1 else [])

    jfeat = jmodel.apply(variables, jnp.asarray(x), train=False, return_features=True)
    with torch.inference_mode():
        feat = model(torch.from_numpy(x), return_features=True)
    assert feat.shape == jfeat.shape and feat.dim() == 5
    np.testing.assert_allclose(to_np(feat), np.asarray(jfeat), **TOL)


@pytest.mark.parametrize("case", ["tiny", "depth1"])
def test_train_mode_logits_and_running_stats_match_flax(case):
    """Train mode with the head's dropout at MODEL.DROPOUT_RATE 0.5: the
    port applies the keep mask the JAX model draws."""
    _, x, jmodel, variables, model = _models(case, seed=4, batch=4)
    key = jax.random.PRNGKey(7)
    want, upd = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                             rngs={"dropout": key})
    (mask,) = jax_dropout_masks(jmodel, variables, x, key)
    assert mask.shape == (4, 24) and 0 < mask.mean() < 1
    model.train()
    got = model(torch.from_numpy(x), head_dropout_mask=torch.tensor(mask, dtype=torch.float32))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    _assert_stats(model, upd["batch_stats"])
    assert int(model.head.conv_5_bn.num_batches_tracked) == 1
    with pytest.raises(ValueError, match="keep mask"):
        model(torch.from_numpy(x))


def test_gradients_match_jax():
    cfg, x, jmodel, variables, model = _models("depth1", seed=8, batch=4)
    g = _input((4, cfg.MODEL.NUM_CLASSES), 9)
    key = jax.random.PRNGKey(10)
    (mask,) = jax_dropout_masks(jmodel, variables, x, key)

    def loss(params):
        out, _ = jmodel.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                              mutable=["batch_stats"], rngs={"dropout": key})
        return jnp.sum(out * g)

    jgrads = state_dict_from_jax(numpy_tree(jax.grad(loss)(variables["params"])))
    model.train()
    out = model(torch.from_numpy(x), head_dropout_mask=torch.tensor(mask, dtype=torch.float32))
    (out * torch.from_numpy(g)).sum().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    # Against the largest gradient: a bias or conv feeding a BatchNorm in
    # train mode only as a per-channel shift has a true gradient of 0.
    scale = max(float(v.abs().max()) for v in jgrads.values())
    for name, want in jgrads.items():
        np.testing.assert_allclose(grads[name].numpy() / scale, want.numpy() / scale,
                                   atol=2e-5, rtol=0, err_msg=name)


def test_weight_decay_mask_matches_jax():
    """BatchNorm weights and biases follow BN.WEIGHT_DECAY (0.0); the SE
    biases and the projection's bias fall under ZERO_WD_1D_PARAM."""
    cfg, _, _, variables, model = _models("depth1")
    for zero_wd_1d in (False, True):
        cfg.SOLVER.ZERO_WD_1D_PARAM = zero_wd_1d
        want = {flax_path_to_torch([str(k.key) for k in path]): bool(v)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    joptim.make_wd_mask(variables["params"], cfg))[0]}
        got = optim.make_wd_mask(model, port_cfg(cfg))
        assert got == want
    assert got["s3.pathway0_res1.branch2.b.weight"] and got["head.lin_5.weight"]
    assert not got["s3.pathway0_res0.branch1_bn.weight"]
    assert not got["s1.pathway0_stem.bn.bias"] and not got["head.projection.bias"]


def _x3d_m_cfg():
    cfg = jax_get_cfg()
    cfg.merge_from_file(X3D_M)
    return cfg


def _jax_names_and_shapes(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(k.key) for k in path]
        shape = tuple(leaf.shape)
        if names[-1] == "kernel":
            shape = {5: lambda s: (s[4], s[3], *s[:3]), 2: lambda s: s[::-1]}[len(shape)](shape)
        out[flax_path_to_torch(names)] = shape
    return out


def test_full_x3d_m_state_dict_matches_jax_tree():
    """Names, shapes and count at full width from jax.eval_shape of the JAX
    init (nothing run at full size), and a strict load of the JAX tree:
    26 blocks, 22 of whose channelwise convs go to K1."""
    cfg = _x3d_m_cfg()
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    x = jax.ShapeDtypeStruct((1, 16, 224, 224, 3), jnp.float32)
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False), x)
    expected = {**_jax_names_and_shapes(shapes["params"]),
                **_jax_names_and_shapes(shapes["batch_stats"])}
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))

    with torch.device("meta"):
        model = px3d.X3D(port_cfg(cfg))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == expected
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert "s2.pathway0_res0.branch2.b.weight" in got and "s5.pathway0_res6.branch2.c_bn.running_var" in got
    assert [s.num_blocks for s in model.stages()] == [3, 5, 11, 7]
    convs = [b.branch2.b for s in model.stages() for b in s.blocks()]
    assert [c.out_channels for c in convs if c.on_k1()] == [54] * 2 + [108] * 4 + [216] * 10 + [432] * 6

    zeros = {name: np.zeros(shape, np.float32) for name, shape in expected.items()}
    model = px3d.X3D(port_cfg(cfg))
    state = {name: torch.from_numpy(v) for name, v in zeros.items()}
    state.update({n: torch.tensor(0) for n in model.state_dict() if n.endswith("num_batches_tracked")})
    model.load_state_dict(state, strict=True)


def _kind(name):
    """A weight's kind: its role in the block, the head or the stem, over
    every block and stage (the digits of ``pathway0_res{i}`` and ``s{i}``
    dropped)."""
    return re.sub(r"^s\d\.pathway0_res\d+\.", "block.", name)


def test_init_matches_jax_init_per_kind():
    """flax's default initializers at full width: per kind of weight, the
    standard deviation within 10% of the JAX init's; biases 0, BatchNorm
    weights 1, running statistics 0 and 1."""
    cfg = _x3d_m_cfg()
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    v = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)), train=False)
    want = state_dict_from_jax(numpy_tree(v))
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32, seed=0)
    got = model.state_dict()
    kinds = {}
    for name in want:
        if name.endswith(("weight",)) and not re.search(r"(_bn|\.bn)\.weight$", name):
            kinds.setdefault(_kind(name), []).append(name)
        else:
            torch.testing.assert_close(got[name], want[name], atol=0, rtol=0, msg=name)
    assert len(kinds) == 11
    for kind, names in kinds.items():
        std_port = float(torch.cat([got[n].flatten() for n in names]).std())
        std_jax = float(torch.cat([want[n].flatten() for n in names]).std())
        assert abs(std_port / std_jax - 1) < 0.1, (kind, std_port, std_jax)
    torch.testing.assert_close(float(got["head.projection.weight"].std()), 0.01, atol=0,
                               rtol=0.05)


def test_norm_types():
    """batchnorm and sync_batchnorm make the one BatchNorm (global batch
    statistics); sub_batchnorm a SubBatchNorm of BN.NUM_SPLITS splits in
    the blocks, the stem's and the head's norms plain, as in the JAX
    package."""
    cfg = port_cfg(tiny_x3d_cfg())
    for norm_type in ("batchnorm", "sync_batchnorm"):
        cfg.BN.NORM_TYPE = norm_type
        norm = get_norm(cfg)(4)
        assert type(norm) is BatchNorm and norm.num_splits == 0
    cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS = "sub_batchnorm", 2
    model = build_model(cfg, device="cpu")
    splits = {name: m.num_splits for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    assert splits["s1.pathway0_stem.bn"] == 0 and 2 in splits.values()
    cfg.BN.NORM_TYPE = "batchnorm"
    cfg.RESNET.TRANS_FUNC = "tf_bottleneck_transform"  # AVSlowFast's audio blocks
    with pytest.raises(NotImplementedError, match="tf_bottleneck_transform"):
        build_model(cfg, device="cpu")
