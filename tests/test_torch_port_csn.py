"""The port's CSN and R(2+1)D against the JAX package's.

On configs/Kinetics/CSN_32x2_R101.yaml and R2PLUS1D_16x4_R50.yaml cut to
depth 18, width 8, 8 frames of 32^2 and 5 classes (``--opts``-style
overrides, not edited), float32 on the CPU; the JAX parameters and
BatchNorm statistics drawn with numpy from a seed on the tree of
``jax.eval_shape`` (tests/test_torch_port_resnet.py's ``jax_variables``),
carried over with ``state_dict_from_jax`` and loaded strictly; the JAX
stem at TPU.FOLD_STEM, its default:

- the eval scores; the train-mode forward with the head's dropout mask
  read off the JAX model and its running statistics; then the gradients of
  a weighted sum of the scores against ``jax.grad`` (relative L2 1e-4),
  JAX's ReLUs taking the port's decisions (``jax_relu_decisions``: a ReLU
  input within a rounding of 0 decides either way); CSN's stride-1 conv_bs
  go through ``ops.depthwise3x3x3`` (the kernel K1 on the card), R(2+1)D's
  convs never;
- one SGD train step of each yaml's recipe (cross-entropy, Nesterov
  momentum, weight decay, head dropout 0.5) against the jitted JAX
  ``make_train_step``: loss and grad norm to rtol 1e-4, top-1/top-5 equal,
  the weights' update (the gradient it holds) to relative L2 1e-4, the
  running statistics;
- the four registry names; the full-size yamls' state_dicts against the
  JAX trees (names, shapes, parameter counts 22,213,776 and 46,979,120); 30
  convs of a CSN-101 on K1's path; a launch plan of the kernels for each of
  CSN-101's conv_b shapes, and at 16 frames (T down to 2) at batch 1.

FLOAT64_GRADS: the gradients and the step are held in float64 activations
on both sides (``jax.enable_x64``; the preprocessing and the loss stay
float32 in the JAX step), as chip_smoke.py holds SlowFast's: with the ReLU
decisions held, JAX's float32 gradients of the tiny CSN lie 6.7e-4 from
float64 ones (relative L2; R(2+1)D's 1.1e-4), the port's 1.0e-4 and 3.1e-5,
so float32 cannot meet 1e-4 between the two; in float64 they lie near 4e-8
apart.

Tolerance: atol 2e-4, rtol 1e-4; running statistics rtol 1e-4, atol 2e-5
(0.1 x a batch statistic, as tests/test_torch_port_slowfast_train.py holds
them: stage 5's BatchNorms normalize 4 values a channel here, which carries
the float32 rounding of 17 convs summed in another order into their
means).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine.train_state import TrainState
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models import optimizer as joptim
from pmv_tpu_torch.engine.steps import init_state, make_train_step
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.models import csn_r2plus1d as pcsn
from pmv_tpu_torch.ops import depthwise as dw
from pmv_tpu_torch.tools.grad_witness import relu_decisions
from pmv_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax
from test_torch_port_depthwise import _check_halo, _check_tiling
from test_torch_port_resnet import _jax_names_and_shapes, jax_variables
from torch_port_util import (  # noqa: F401
    depthwise_calls,
    jax_dropout_key,
    jax_dropout_masks,
    jax_relu_decisions,
    jax_train_draws,
    numpy_tree,
    port_cfg,
    to_np,
)

KINETICS = Path(__file__).resolve().parents[1] / "configs" / "Kinetics"
YAMLS = {"csn": "CSN_32x2_R101", "r2plus1d": "R2PLUS1D_16x4_R50"}
PARAMS = {"csn": 22_213_776, "r2plus1d": 46_979_120}
TOL = dict(atol=2e-4, rtol=1e-4)
TINY = ("RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8", "DATA.NUM_FRAMES", "8",
        "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32", "MODEL.NUM_CLASSES", "5",
        "TRAIN.MIXED_PRECISION", "False", "NUM_GPUS", "1")


def tiny_cfg(variant, *opts):
    cfg = jax_get_cfg()
    cfg.merge_from_file(str(KINETICS / f"{YAMLS[variant]}.yaml"))
    cfg.merge_from_list(list(TINY + opts))
    return cfg


def _frames(batch, seed):
    return np.random.default_rng(seed).normal(size=(batch, 8, 32, 32, 3)).astype(np.float32)


def _models(variant, seed=2, batch=2):
    cfg = tiny_cfg(variant)
    x = _frames(batch, seed)
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    variables = jax_variables(jmodel, jnp.asarray(x), seed + 1)
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    load_jax_params(model, variables)
    return x, jmodel, variables, model


def _assert_stats(model, batch_stats):
    want = state_dict_from_jax({"params": {}, "batch_stats": numpy_tree(batch_stats)})
    got = model.state_dict()
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=1e-4, atol=2e-5,
                                       err_msg=name)


def _rel_l2(got, want):
    diff = sum(float((got[k] - v).square().sum()) for k, v in want.items())
    return (diff / sum(float(v.square().sum()) for v in want.values())) ** 0.5


@pytest.mark.parametrize("variant", sorted(YAMLS))
def test_eval_scores_match_jax(variant, depthwise_calls):  # noqa: F811
    x, jmodel, variables, model = _models(variant)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    model.eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 5) and float(want.max()) < 0.99
    np.testing.assert_allclose(to_np(got), want, **TOL)
    # Depth 18: blocks [2, 2, 2, 2], the first of stages 3-5 strided.
    assert len(depthwise_calls) == (5 if variant == "csn" else 0)


def _float64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("variant", sorted(YAMLS))
def test_train_forward_stats_and_gradients_match_jax(variant, depthwise_calls):  # noqa: F811
    """Train mode with the head's dropout (the yamls' 0.5), the port
    applying the keep mask the JAX model draws: the scores and the running
    statistics in float32; then the gradients of a weighted sum of the
    scores against ``jax.grad``, both sides in float64 (``FLOAT64_GRADS``)."""
    x, jmodel, variables, model = _models(variant, seed=4, batch=4)
    key = jax.random.PRNGKey(7)
    (mask,) = jax_dropout_masks(jmodel, variables, jnp.asarray(x), key)
    assert mask.shape == (4, 256) and 0 < mask.mean() < 1
    g = np.random.default_rng(9).normal(size=(4, 5))
    model.train()
    with relu_decisions() as decisions:
        out = model(torch.from_numpy(x), head_dropout_mask=torch.tensor(mask, dtype=torch.float32))
    want, upd = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"],
                                                  rngs={"dropout": key}))(variables, x)
    np.testing.assert_allclose(to_np(out), np.asarray(want), **TOL)
    _assert_stats(model, upd["batch_stats"])
    assert len(depthwise_calls) == (5 if variant == "csn" else 0)

    with jax.enable_x64(True):
        jmodel64 = jax_build_model(tiny_cfg(variant), dtype=jnp.float64)
        v64 = _float64(variables)

        def loss(params):
            out = jmodel64.apply({**v64, "params": params}, jnp.asarray(x, jnp.float64),
                                 train=True, mutable=["batch_stats"], rngs={"dropout": key})[0]
            return jnp.sum(out * g)

        # Under x64 flax's dropout draws its bits anew: the mask is read again.
        (mask,) = jax_dropout_masks(jmodel64, v64, jnp.asarray(x, jnp.float64), key)
        model64 = build_model(port_cfg(tiny_cfg(variant)), device="cpu", dtype=torch.float64)
        load_jax_params(model64, variables)
        model64.double().train()
        with relu_decisions() as decisions:
            out = model64(torch.from_numpy(x).double(),
                          head_dropout_mask=torch.tensor(mask, dtype=torch.float64))
        (out * torch.from_numpy(g)).sum().backward()
        with jax_relu_decisions(decisions):
            jgrads = jax.jit(jax.grad(loss))(v64["params"])
    jgrads = state_dict_from_jax(numpy_tree(jgrads))
    grads = {n: p.grad for n, p in model64.named_parameters()}
    assert set(grads) == set(jgrads)
    assert _rel_l2(grads, jgrads) < 1e-4


@pytest.mark.parametrize("variant", sorted(YAMLS))
def test_sgd_train_step_matches_jax(variant):
    """Both steps in float64 activations (``FLOAT64_GRADS``), JAX's ReLUs
    taking the port's decisions."""
    cfg = tiny_cfg(variant)
    assert cfg.SOLVER.OPTIMIZING_METHOD == "sgd" and cfg.SOLVER.NESTEROV
    rng = np.random.default_rng(5)
    batch = {"frames": rng.integers(0, 256, (4, 8, 32, 32, 3), np.uint8),
             "labels": rng.integers(0, 5, 4)}
    lr = 0.05
    with jax.enable_x64(True):
        jmodel = jax_build_model(cfg, dtype=jnp.float64)
        x = jsteps.make_eval_preprocess_fn(cfg)(jnp.asarray(batch["frames"]))
        variables = _float64(jax_variables(jmodel, x, 6))
        tx = joptim.construct_optimizer(variables["params"], cfg)
        jstate = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]))
        key = jax.random.PRNGKey(3)
        (mask,) = jax_dropout_masks(jmodel, variables, x, jax_dropout_key(key, 0))
        model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float64)
        load_jax_params(model, variables)
        model.double()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        step = make_train_step(port_cfg(cfg), device="cpu")
        draws = {**jax_train_draws(cfg, key, 0, batch["frames"].shape),
                 "dropout": torch.tensor(mask, dtype=torch.float64)}
        with relu_decisions() as decisions:
            m = step(init_state(port_cfg(cfg), model), batch, lr, draws)
        with jax_relu_decisions(decisions):
            jstate, jm = jax.jit(jsteps.make_train_step(cfg, jmodel, tx))(
                jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key, lr)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert float(m["top1_err"]) == float(jm["top1_err"])
    assert float(m["top5_err"]) == float(jm["top5_err"])
    want = state_dict_from_jax(numpy_tree({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}))
    got = model.state_dict()
    names = [n for n in want if "running" not in n and not n.endswith("num_batches_tracked")]
    assert _rel_l2({n: before[n] - got[n] for n in names},
                   {n: before[n] - want[n] for n in names}) < 1e-4
    _assert_stats(model, jstate.batch_stats)


@pytest.mark.parametrize("name", ["PTVCSN", "CSN", "PTVR2plus1D", "R2Plus1D"])
def test_registry_names_build_the_jax_tree(name):
    """Each of the four names builds the net the JAX package's name builds:
    the same state_dict names and shapes at the tiny size."""
    variant = "csn" if "CSN" in name else "r2plus1d"
    cfg = tiny_cfg(variant, "MODEL.MODEL_NAME", name)
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 32, 32, 3)), train=False))
    expected = {**_jax_names_and_shapes(shapes["params"]),
                **_jax_names_and_shapes(shapes["batch_stats"])}
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    assert isinstance(model, pcsn.SeparatedConvNet) and model.pool == (variant == "csn")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == expected


@pytest.mark.parametrize("variant", sorted(YAMLS))
def test_full_size_yaml_matches_the_jax_tree(variant):
    """Names, shapes and the parameter count of each yaml at full width
    from jax.eval_shape of the JAX init (nothing run at full size); the
    port's model built on the meta device."""
    from pmv_tpu_torch.config import get_cfg

    cfg = jax_get_cfg()
    cfg.merge_from_file(str(KINETICS / f"{YAMLS[variant]}.yaml"))
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    x = jax.ShapeDtypeStruct((1, cfg.DATA.NUM_FRAMES, 224, 224, 3), jnp.float32)
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False), x)
    expected = {**_jax_names_and_shapes(shapes["params"]),
                **_jax_names_and_shapes(shapes["batch_stats"])}
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    pcfg = get_cfg()
    pcfg.merge_from_file(str(KINETICS / f"{YAMLS[variant]}.yaml"))
    with torch.device("meta"):
        model = pcsn.SeparatedConvNet(pcfg, variant)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == expected
    assert sum(p.numel() for p in model.parameters()) == n_jax == PARAMS[variant]
    if variant == "r2plus1d":  # the middle widths 27 c^2 / 12 c
        assert [got[f"s{s}.res0.branch2.b_xy.weight"][0] for s in range(2, 6)] == [
            144, 288, 576, 1152]


def test_csn_101_sends_30_convs_to_k1():
    """3 + 3 + 22 + 2 stride-1 conv_bs of ir-CSN-101 on K1's path; the 3
    strided ones, and every other conv, not. Built only."""
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(KINETICS / "CSN_32x2_R101.yaml"))
    with torch.device("meta"):
        model = pcsn.SeparatedConvNet(cfg, "csn")
    on_k1 = [n for n, m in model.named_modules() if hasattr(m, "on_k1") and m.on_k1()]
    assert len(on_k1) == 30
    assert all(n.endswith("branch2.b") for n in on_k1)
    per_stage = [sum(n.startswith(f"s{s}.") for n in on_k1) for s in range(2, 6)]
    assert per_stage == [n for _, n in dw.CSN_DW_SHAPES] == [3, 3, 22, 2]
    assert not model.s3.res0.branch2.b.on_k1()  # strided (2, 2, 2)


# ir-CSN-101's conv_b shapes at batch 8 (32 x 224^2 and the 256^2 test
# crop), and at batch 1 on 16 frames, the card-against-CPU step's (T down
# to 2 in stage 5).
CSN_PLAN_SHAPES = [s for s, _ in dw.CSN_DW_SHAPES + dw.CSN_TEST_DW_SHAPES] + [
    (1, 16, 56, 56, 64), (1, 8, 28, 28, 128), (1, 4, 14, 14, 256), (1, 2, 7, 7, 512)]


@pytest.mark.parametrize("kernel", ["forward", "wgrad"])
@pytest.mark.parametrize("elem", [2, 4], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("shape", CSN_PLAN_SHAPES)
def test_a_launch_plan_fits_each_csn_shape(shape, elem, kernel):
    plan = (dw.plan_forward if kernel == "forward" else dw.plan_wgrad)(shape, elem)
    _check_tiling(plan)
    _check_halo(plan)
    assert plan.smem_bytes <= dw.SMEM_PER_BLOCK
    if shape[0] == 8:  # enough blocks to fill an H100
        assert plan.blocks >= dw.H100_SMS
