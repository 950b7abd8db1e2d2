"""The port's ResNet family (C2D, I3D, Slow, SlowFast, non-local) against the
JAX package's.

On configs/tiny_slowfast_synthetic.yaml (ResNet-18 depth of bottleneck
blocks at width 8, SlowFast's fast pathway at width 2), loaded with
``--opts``-style overrides (``merge_from_list``), not edited. Inputs
[2, 8, 32, 32, 3], float32 on the CPU; the JAX parameters and BatchNorm
statistics are drawn with numpy from a seed on the tree of
``jax.eval_shape`` (conv and dense kernels normal of variance 1 / fan-in,
BatchNorm scales near 1, the non-local blocks' too, biases and statistics
near 0 and 1), carried over with ``state_dict_from_jax`` and loaded
strictly; the JAX side at TPU.FOLD_STEM on (its default: the stem's
stride and output blocks folded into channels, BatchNorm in the folded
layout) and off:

- ``ResNetBasicStem``, ``BasicTransform``, ``BottleneckTransform`` (strides
  on the 1x1 or on the 3x3 conv, groups, dilation), ``Nonlocal`` (softmax
  and dot product, with and without the max pool), ``ResNetBasicHead`` and
  ``FuseFastToSlow`` one by one, at eval and in train mode with their
  running statistics;
- the eval scores of c2d at depth 18 with basic blocks and at depth 50
  with bottlenecks, i3d, slow, i3d with softmax non-local blocks, a dilated
  res5 and SlowFast; the features of ``return_features``; no call into
  ``ops.depthwise3x3x3`` (no conv of these nets is on K1);
- SlowFast's train-mode forward with the head's dropout mask read off the
  JAX model, its running statistics, and every gradient against
  ``jax.grad`` with the ReLUs deciding alike (``jax_relu_decisions``), over
  the largest gradient;
- ``pack_pathways`` against the JAX package's (the slow pathway is frames
  0, ALPHA, 2 ALPHA, ...) and ``make_wd_mask`` on SlowFast's names;
- full-width SlowFast 8x8 R50: the state_dict against the JAX tree from
  ``jax.eval_shape`` (names, shapes, the parameter count, a strict load);
  each ResNet-family Kinetics yaml builds; the init's non-local BatchNorm
  scales 0 and the projection's standard deviation 0.01.

Tolerance: atol 2e-4, rtol 1e-4 (running statistics rtol 1e-4, atol 1e-6).
"""

from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models import heads as jheads
from pmv_tpu.models import nonlocal_block as jnl
from pmv_tpu.models import optimizer as joptim
from pmv_tpu.models import resnet as jresnet
from pmv_tpu.models import resnet_helper as jrh
from pmv_tpu.models import stem as jstem
from pmv_tpu.models.batchnorm import get_norm as jax_get_norm
from pmv_tpu_torch.engine import steps as psteps
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.models import heads as pheads
from pmv_tpu_torch.models import nonlocal_block as pnl
from pmv_tpu_torch.models import optimizer as optim
from pmv_tpu_torch.models import resnet as presnet
from pmv_tpu_torch.models import resnet_helper as prh
from pmv_tpu_torch.models import stem as pstem
from pmv_tpu_torch.models.batchnorm import BatchNorm
from pmv_tpu_torch.utils.weights import flax_path_to_torch, load_jax_params, state_dict_from_jax
from pmv_tpu_torch.tools.grad_witness import relu_decisions
from torch_port_util import (  # noqa: F401
    depthwise_calls,
    draw_variables,
    jax_dropout_masks,
    jax_relu_decisions,
    port_cfg,
    to_np,
)

ROOT = Path(__file__).resolve().parents[1]
TINY_SLOWFAST = str(ROOT / "configs" / "tiny_slowfast_synthetic.yaml")
KINETICS = ROOT / "configs" / "Kinetics"
TOL = dict(atol=2e-4, rtol=1e-4)


def tiny_cfg(*opts):
    """configs/tiny_slowfast_synthetic.yaml with ``opts`` (KEY VALUE ...)."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(TINY_SLOWFAST)
    cfg.merge_from_list(list(opts))
    return cfg


def jax_variables(module, x, seed, **kwargs):
    shapes = jax.eval_shape(
        lambda x: module.init(jax.random.PRNGKey(0), x, train=False, **kwargs), x)
    return draw_variables(dict(shapes), seed)


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


JNORM = partial(jax_get_norm(tiny_cfg()), dtype=jnp.float32)


def _stem(fold):
    kw = dict(kernel=(5, 7, 7), stride=(1, 2, 2), padding=(2, 3, 3))
    return (lambda: jstem.ResNetBasicStem(dim_out=8, use_fold=fold, **kw),
            lambda: pstem.ResNetBasicStem(3, 8, **kw), (2, 4, 32, 32, 3))


def _bottleneck(stride_1x1, groups, dilation, stride=2):
    kw = dict(temp_kernel_size=3, stride=stride, dim_inner=8, num_groups=groups,
              stride_1x1=stride_1x1, dilation=dilation)
    return (lambda: jrh.BottleneckTransform(dim_out=16, norm=JNORM, **kw),
            lambda: prh.BottleneckTransform(12, 16, norm=BatchNorm, **kw), (2, 3, 9, 8, 12))


def _nonlocal(instantiation, pool):
    return (lambda: jnl.Nonlocal(dim_inner=6, pool_size=pool, instantiation=instantiation,
                                 zero_init_final_norm=False),
            lambda: pnl.Nonlocal(12, 6, pool, instantiation), (2, 3, 6, 5, 12))


class _JaxFuse(jresnet.FuseFastToSlow):
    """The JAX fusion on one [slow, fast] list, as the port's takes it."""

    def __call__(self, xs, train=True):
        return super().__call__(xs[0], xs[1], train=train)


# name -> (JAX module, port module, input shape; a list of shapes for a list)
MODULES = {
    "ResNetBasicStem_fold": _stem(True),
    "ResNetBasicStem": _stem(False),
    "BasicTransform": (
        lambda: jrh.BasicTransform(dim_out=16, temp_kernel_size=3, stride=2, norm=JNORM),
        lambda: prh.BasicTransform(12, 16, 3, 2, BatchNorm), (2, 3, 9, 8, 12)),
    "Bottleneck_stride_3x3": _bottleneck(False, 1, 1),
    "Bottleneck_stride_1x1_groups": _bottleneck(True, 2, 1),
    "Bottleneck_dilated": _bottleneck(False, 1, 2, stride=1),
    "Nonlocal_softmax_pool": _nonlocal("softmax", (1, 2, 2)),
    "Nonlocal_dot_product": _nonlocal("dot_product", None),
    "ResNetBasicHead": (
        lambda: jheads.ResNetBasicHead(num_classes=5),
        lambda: pheads.ResNetBasicHead([12, 4], 5), [(3, 2, 3, 3, 12), (3, 4, 3, 3, 4)]),
    "FuseFastToSlow": (
        lambda: _JaxFuse(dim_in=4, fusion_conv_channel_ratio=2, fusion_kernel=5, alpha=4,
                         norm=JNORM),
        lambda: presnet.FuseFastToSlow(4, 2, 5, 4, BatchNorm), [(2, 2, 5, 5, 12), (2, 8, 5, 5, 4)]),
}


def _to_jax(x):
    return [jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)


def _to_torch(x):
    return [torch.from_numpy(a) for a in x] if isinstance(x, list) else torch.from_numpy(x)


def _as_list(y):
    return list(y) if isinstance(y, (list, tuple)) else [y]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, train, depthwise_calls):  # noqa: F811
    make_jax, make_port, shape = MODULES[name]
    x = ([_input(s, i) for i, s in enumerate(shape)] if isinstance(shape, list)
         else _input(shape, 0))
    jmod = make_jax()
    variables = jax_variables(jmod, _to_jax(x), 1)
    if train:
        want, upd = jmod.apply(variables, _to_jax(x), train=True, mutable=["batch_stats"])
    else:
        want, upd = jmod.apply(variables, _to_jax(x), train=False), None
    module = make_port()
    load_jax_params(module, variables)
    module.train(train)
    got = module(_to_torch(x))
    for g, w in zip(_as_list(got), _as_list(want), strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)
    assert not depthwise_calls
    if upd is not None and "batch_stats" in upd:
        _assert_stats(module, upd["batch_stats"])


RESNET_R18 = ("MODEL.ARCH", "c2d", "MODEL.MODEL_NAME", "ResNet", "DATA.INPUT_CHANNEL_NUM", "[3]",
              "RESNET.NUM_BLOCK_TEMP_KERNEL", "[[2], [2], [2], [2]]",
              "RESNET.SPATIAL_STRIDES", "[[1], [2], [2], [2]]",
              "RESNET.SPATIAL_DILATIONS", "[[1], [1], [1], [1]]")
MODELS = {  # name -> opts over the tiny config
    "c2d_r18_basic": RESNET_R18 + ("RESNET.TRANS_FUNC", "basic_transform"),
    "c2d_r50": RESNET_R18 + ("RESNET.DEPTH", "50", "RESNET.NUM_BLOCK_TEMP_KERNEL",
                             "[[3], [4], [6], [3]]"),
    "i3d": RESNET_R18 + ("MODEL.ARCH", "i3d"),
    "slow": RESNET_R18 + ("MODEL.ARCH", "slow"),
    "i3d_nonlocal_softmax": RESNET_R18 + (
        "MODEL.ARCH", "i3d", "NONLOCAL.LOCATION", "[[[]], [[1]], [[0, 1]], [[]]]",
        "NONLOCAL.INSTANTIATION", "softmax"),
    "dilated_res5": RESNET_R18 + ("RESNET.SPATIAL_STRIDES", "[[1], [2], [2], [1]]",
                                  "RESNET.SPATIAL_DILATIONS", "[[1], [1], [1], [2]]"),
    "slowfast": (),
}
FOLD_CASES = [(name, True) for name in sorted(MODELS)] + [
    ("c2d_r18_basic", False), ("slowfast", False)]


def _models(name, fold=True, seed=2, batch=2, size=32):
    cfg = tiny_cfg(*MODELS[name], "TPU.FOLD_STEM", str(fold))
    x = _input((batch, 8, size, size, 3), seed)
    jx = [jnp.asarray(a) for a in jsteps.pack_pathways(cfg, jnp.asarray(x))]
    jx = jx[0] if len(jx) == 1 else jx
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    variables = jax_variables(jmodel, jx, seed + 1)
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    load_jax_params(model, variables)
    px = psteps.model_input(port_cfg(cfg), torch.from_numpy(x))
    return cfg, jx, px, jmodel, variables, model


@pytest.mark.parametrize("name,fold", FOLD_CASES,
                         ids=[f"{n}-{'fold' if f else 'nofold'}" for n, f in FOLD_CASES])
def test_eval_scores_match_jax(name, fold, depthwise_calls):  # noqa: F811
    _, jx, px, jmodel, variables, model = _models(name, fold)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jx))
    model.eval()
    with torch.inference_mode():
        got = model(px)
    assert got.shape == (2, 5)
    assert float(want.max()) < 0.99  # scores, not a saturated softmax
    np.testing.assert_allclose(to_np(got), want, **TOL)
    assert not depthwise_calls
    nonlocal_blocks = [m for m in model.modules() if isinstance(m, pnl.Nonlocal)]
    assert len(nonlocal_blocks) == (3 if name == "i3d_nonlocal_softmax" else 0)


def test_return_features_match_jax():
    _, jx, px, jmodel, variables, model = _models("i3d_nonlocal_softmax")
    want = jmodel.apply(variables, jx, train=False, return_features=True)
    model.eval()
    with torch.inference_mode():
        got = model(px, return_features=True)
    assert got.shape == want.shape == (2, 4, 1, 1, 256)  # i3d's pool1 halves T
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_slowfast_train_forward_stats_and_gradients_match_jax():
    """Train mode with the head's dropout at MODEL.DROPOUT_RATE 0.5, the
    port applying the keep mask the JAX model draws; the running statistics;
    the gradients of a weighted sum of the logits against ``jax.grad``,
    over the largest gradient, to the file's atol, with JAX's ReLUs taking
    the port's decisions (``jax_relu_decisions``): a ReLU input within a
    rounding of 0 decides either way in float32 and moves the gradients of
    every earlier layer by percents (``python -m
    pmv_tpu_torch.tools.grad_witness --cfg configs/Kinetics/SLOWFAST_8x8_R50.yaml
    --cpu-only --frames 8 --crop 64`` reads it against float64)."""
    cfg, jx, px, jmodel, variables, model = _models("slowfast", seed=4, batch=4)
    key = jax.random.PRNGKey(7)
    (mask,) = jax_dropout_masks(jmodel, variables, jx, key)
    assert mask.shape == (4, 256 + 64) and 0 < mask.mean() < 1
    g = _input((4, 5), 9)
    model.train()
    with relu_decisions() as decisions:
        out = model(px, head_dropout_mask=torch.tensor(mask, dtype=torch.float32))

    def loss(params):
        out, upd = jmodel.apply({**variables, "params": params}, jx, train=True,
                                mutable=["batch_stats"], rngs={"dropout": key})
        return jnp.sum(out * g), (out, upd)

    with jax_relu_decisions(decisions):
        (_, (want, upd)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
    np.testing.assert_allclose(to_np(out), np.asarray(want), **TOL)
    _assert_stats(model, upd["batch_stats"])
    assert int(model.s1_fuse.bn.num_batches_tracked) == 1
    (out * torch.from_numpy(g)).sum().backward()
    jgrads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    # Against the largest gradient: a conv feeding a BatchNorm in train mode
    # only as a per-channel shift has a true gradient of 0.
    scale = max(float(v.abs().max()) for v in jgrads.values())
    for name, want in jgrads.items():
        np.testing.assert_allclose(grads[name].numpy() / scale, want.numpy() / scale,
                                   atol=TOL["atol"], rtol=0, err_msg=name)
    with pytest.raises(ValueError, match="keep mask"):
        model(px)


def test_pack_pathways_matches_jax():
    """The slow pathway is every ALPHA-th frame from the first: at T = 32,
    ALPHA = 4, frames 0, 4, ..., 28 (ROADMAP.md: PySlowFast's
    ``pack_pathway_output`` spreads them with a linspace instead)."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(str(KINETICS / "SLOWFAST_8x8_R50.yaml"))
    x = np.arange(2 * 32, dtype=np.float32).reshape(2, 32, 1, 1, 1)
    want = [np.asarray(a) for a in jsteps.pack_pathways(cfg, jnp.asarray(x))]
    got = psteps.pack_pathways(port_cfg(cfg), torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0][0, :, 0, 0, 0].tolist() == list(range(0, 32, 4))
    # AVSlowFast: the audio, and the misaligned audio where given, after
    # the two; without the audio both packages refuse.
    cfg.MODEL.ARCH = "avslowfast"
    audio = np.random.default_rng(0).normal(size=(2, 8, 4)).astype(np.float32)
    for extra in ([audio], [audio, audio + 1]):
        want = jsteps.pack_pathways(cfg, jnp.asarray(x), *map(jnp.asarray, extra))
        got = psteps.pack_pathways(port_cfg(cfg), torch.from_numpy(x),
                                   *map(torch.from_numpy, extra))
        assert len(got) == len(want) == 2 + len(extra)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(AssertionError, match="audio"):
        jsteps.pack_pathways(cfg, jnp.asarray(x))
    with pytest.raises(ValueError, match="audio"):
        psteps.pack_pathways(port_cfg(cfg), torch.from_numpy(x))


def test_weight_decay_mask_matches_jax():
    """The fusions' and the stems' BatchNorms follow BN.WEIGHT_DECAY (0.0);
    biases fall under ZERO_WD_1D_PARAM."""
    cfg, _, _, _, variables, model = _models("slowfast")
    for zero_wd_1d in (False, True):
        cfg.SOLVER.ZERO_WD_1D_PARAM = zero_wd_1d
        want = {flax_path_to_torch([str(k.key) for k in path]): bool(v)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    joptim.make_wd_mask(variables["params"], cfg))[0]}
        assert optim.make_wd_mask(model, port_cfg(cfg)) == want
    got = optim.make_wd_mask(model, port_cfg(cfg))
    assert got["s1_fuse.conv_f2s.weight"] and got["s3.pathway1_res0.branch2.b.weight"]
    assert not got["s1_fuse.bn.weight"] and not got["s1.pathway1_stem.bn.bias"]


def _jax_names_and_shapes(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(k.key) for k in path]
        shape = tuple(leaf.shape)
        if names[-1] == "kernel":
            shape = {5: lambda s: (s[4], s[3], *s[:3]), 2: lambda s: s[::-1]}[len(shape)](shape)
        out[flax_path_to_torch(names)] = shape
    return out


def test_full_slowfast_8x8_r50_state_dict_matches_jax_tree():
    """Names, shapes and the parameter count at full width from
    jax.eval_shape of the JAX init (nothing run at full size), and a strict
    load of the JAX tree."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(str(KINETICS / "SLOWFAST_8x8_R50.yaml"))
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    x = [jax.ShapeDtypeStruct((1, 8, 224, 224, 3), jnp.float32),
         jax.ShapeDtypeStruct((1, 32, 224, 224, 3), jnp.float32)]
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False), x)
    expected = {**_jax_names_and_shapes(shapes["params"]),
                **_jax_names_and_shapes(shapes["batch_stats"])}
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))

    with torch.device("meta"):
        model = presnet.SlowFast(port_cfg(cfg))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == expected
    assert sum(p.numel() for p in model.parameters()) == n_jax == 34_566_488
    assert got["s1.pathway1_stem.conv.weight"] == (8, 3, 5, 7, 7)
    assert got["s2_fuse.conv_f2s.weight"] == (64, 32, 7, 1, 1)
    assert got["s5.pathway1_res2.branch2.c_bn.running_var"] == (256,)
    assert [len(layers) for s in model.stages() for layers in s.pathway_layers] == [
        3, 3, 4, 4, 6, 6, 3, 3]

    model = presnet.SlowFast(port_cfg(cfg))
    state = {name: torch.zeros(shape) for name, shape in expected.items()}
    state.update({n: torch.tensor(0) for n in model.state_dict()
                  if n.endswith("num_batches_tracked")})
    model.load_state_dict(state, strict=True)


YAMLS = ["C2D_8x8_R50", "I3D_8x8_R50", "SLOW_8x8_R50", "SLOWFAST_8x8_R50", "SLOWFAST_4x16_R50",
         "SLOWFAST_NLN_8x8_R50"]


@pytest.mark.parametrize("name", YAMLS)
def test_kinetics_yaml_builds(name):
    """Each ResNet-family Kinetics yaml builds on the CPU at full size; the
    non-local yaml's blocks are not built, as in the JAX package's SlowFast
    (ROADMAP.md)."""
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(KINETICS / f"{name}.yaml"))
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=0)
    assert isinstance(model, presnet.SlowFast if "SLOWFAST" in name else presnet.ResNetModel)
    assert not any(isinstance(m, pnl.Nonlocal) for m in model.modules())


def test_detection_head_is_refused():
    """AVA's yamls build the detection head (ported in slice 14, held to
    JAX in tests/test_torch_port_detection.py); a net of the family with no
    detection head in the JAX package (CSN) refuses DETECTION.ENABLE."""
    from pmv_tpu_torch.config import get_cfg
    from pmv_tpu_torch.models.heads import ResNetRoIHead

    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / "configs" / "AVA" / "SLOWFAST_32x2_R50_SHORT.yaml"))
    with torch.device("meta"):
        model = presnet.SlowFast(cfg)
    assert isinstance(model.head, ResNetRoIHead) and model.head.resolution == 7
    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / "configs" / "Kinetics" / "CSN_32x2_R101.yaml"))
    cfg.DETECTION.ENABLE = True
    with pytest.raises(NotImplementedError, match="detection head"):
        build_model(cfg, device="cpu")


def test_init_zeroes_the_nonlocal_norm_and_draws_the_projection_at_0_01():
    cfg = port_cfg(tiny_cfg(*MODELS["i3d_nonlocal_softmax"], "RESNET.WIDTH_PER_GROUP", "64"))
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=0)
    blocks = [m for m in model.modules() if isinstance(m, pnl.Nonlocal)]
    assert len(blocks) == 3
    for m in blocks:
        assert torch.equal(m.bn.weight, torch.zeros_like(m.bn.weight))
        assert torch.equal(m.conv_theta.bias, torch.zeros_like(m.conv_theta.bias))
    torch.testing.assert_close(float(model.head.projection.weight.detach().std()), 0.01, atol=0,
                               rtol=0.05)
    w = model.s3.pathway0_res0.branch2.b.weight  # lecun normal: std sqrt(1 / fan-in)
    torch.testing.assert_close(float(w.detach().std()), (1 / w[0].numel()) ** 0.5, atol=0,
                               rtol=0.05)
    assert model.sample_drop_path_masks(2, torch.Generator()) is None
