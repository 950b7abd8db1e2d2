"""The port's losses, LR policies and optimizer against the JAX package's.

- Every entry of ``get_loss_func``, both reductions (float32, atol 1e-6).
- ``get_lr_at_epoch`` on a grid of fractional epochs: cosine (with and
  without COSINE_AFTER_WARMUP and an end LR), steps with relative LRs, and
  linear warmup. The same arithmetic, so the schedules are equal.
- Two optimizer updates from the same parameters and gradients against the
  optax chain of ``pmv_tpu.models.optimizer.construct_optimizer`` at tiny
  MViT width: the weight-decay mask and the layer-decay scales, clipping by
  global norm above and below the threshold and by value, AdamW and SGD
  (Nesterov, LARS). float32; parameters to atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _mvitv2_s_cfg
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models import losses as jlosses
from pmv_tpu.models import optimizer as joptim
from pmv_tpu.utils import lr_policy as jlr
from pmv_tpu_torch.models import build_model, losses, optimizer
from pmv_tpu_torch.utils import lr_policy
from pmv_tpu_torch.utils.weights import flax_path_to_torch, load_jax_params, state_dict_from_jax
from torch_port_util import port_cfg, random_params


@pytest.mark.parametrize("name", sorted(jlosses._LOSSES))
def test_losses_match_jax(name):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 5)).astype(np.float32) * 3
    if name == "cross_entropy":
        targets = rng.integers(0, 5, 6)
    elif name == "bce":
        logits = 1 / (1 + np.exp(-logits))
        logits[0, 0], logits[1, 1] = 0.0, 1.0  # the clip at 1e-8
        targets = (rng.random((6, 5)) > 0.5).astype(np.float32)
    else:
        targets = rng.random((6, 5)).astype(np.float32)
    jfn, fn = jlosses.get_loss_func(name), losses.get_loss_func(name)
    for reduction in ("mean", "none"):
        ref = jfn(jnp.asarray(logits), jnp.asarray(targets), reduction=reduction)
        out = fn(torch.from_numpy(logits), torch.from_numpy(targets), reduction=reduction)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    if name == "soft_cross_entropy":
        ref = jfn(jnp.asarray(logits), jnp.asarray(targets), normalize_targets=True)
        out = fn(torch.from_numpy(logits), torch.from_numpy(targets), normalize_targets=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        losses.get_loss_func("hinge")


def _lr_cfg(policy, **solver):
    cfg = _mvitv2_s_cfg(tiny=True)
    cfg.SOLVER.LR_POLICY = policy
    cfg.SOLVER.BASE_LR = 0.4
    cfg.SOLVER.MAX_EPOCH = 30
    for k, v in solver.items():
        setattr(cfg.SOLVER, k, v)
    return cfg


@pytest.mark.parametrize(
    "policy, solver",
    [
        ("cosine", {}),
        ("cosine", dict(COSINE_END_LR=0.01, WARMUP_EPOCHS=3.0, WARMUP_START_LR=0.001)),
        ("cosine", dict(COSINE_AFTER_WARMUP=True, WARMUP_EPOCHS=5.0, WARMUP_START_LR=0.0)),
        ("steps_with_relative_lrs", dict(STEPS=[0, 10, 20], LRS=[1.0, 0.1, 0.01])),
        ("steps_with_relative_lrs", dict(STEPS=[0, 8], LRS=[1.0, 0.5], WARMUP_EPOCHS=2.0)),
    ],
)
def test_lr_schedules_match_jax(policy, solver):
    cfg = _lr_cfg(policy, **solver)
    pcfg = port_cfg(cfg)
    epochs = [e + i / 7 for e in range(cfg.SOLVER.MAX_EPOCH) for i in range(7)]
    ours = [lr_policy.get_lr_at_epoch(pcfg, e) for e in epochs]
    assert ours == [jlr.get_lr_at_epoch(cfg, e) for e in epochs]
    assert ours == [optimizer.get_epoch_lr(e, pcfg) for e in epochs]


CASES = {
    "adamw_clipped_layer_decay": dict(
        OPTIMIZING_METHOD="adamw", CLIP_GRAD_L2NORM=0.5, LAYER_DECAY=0.75),
    "adamw_below_clip": dict(OPTIMIZING_METHOD="adamw", CLIP_GRAD_L2NORM=1e4),
    "sgd_nesterov_clipped": dict(OPTIMIZING_METHOD="sgd", CLIP_GRAD_L2NORM=0.5),
    "sgd_lars_clip_value": dict(
        OPTIMIZING_METHOD="sgd", CLIP_GRAD_L2NORM=None, CLIP_GRAD_VAL=0.05,
        LARS_ON=True, NESTEROV=False),
}


@pytest.fixture(scope="module")
def tiny_params():
    cfg = _mvitv2_s_cfg(tiny=True)
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    x = jnp.zeros((1, 2, 16, 16, 3), jnp.float32)
    params = jax.jit(lambda k: jmodel.init(k, x, train=False))(jax.random.PRNGKey(0))
    return random_params(params["params"], 1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_update_matches_optax(case, tiny_params):
    cfg = _mvitv2_s_cfg(tiny=True)
    cfg.SOLVER.WEIGHT_DECAY = 0.05
    cfg.SOLVER.BASE_LR = 0.02
    cfg.SOLVER.LAYER_DECAY = 1.0
    for k, v in CASES[case].items():
        setattr(cfg.SOLVER, k, v)
    pcfg = port_cfg(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tiny_params)
    rng = np.random.default_rng(2)
    grads = [
        jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * 0.1), params
        )
        for _ in range(2)
    ]
    lrs = [0.02, 0.013]

    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    load_jax_params(model, tiny_params)
    opt = optimizer.construct_optimizer(model, pcfg)
    named = dict(model.named_parameters())

    # The masks, name by name.
    jmask = jax.tree_util.tree_flatten_with_path(joptim.make_wd_mask(params, cfg))[0]
    ref_mask = {flax_path_to_torch([str(k.key) for k in path]): bool(v) for path, v in jmask}
    assert optimizer.make_wd_mask(model, pcfg) == ref_mask
    assert 0 < sum(ref_mask.values()) < len(ref_mask)
    if cfg.SOLVER.LAYER_DECAY < 1.0:
        jscales = jax.tree_util.tree_flatten_with_path(
            joptim.make_layer_decay_scales(params, cfg))[0]
        ref_scales = {flax_path_to_torch([str(k.key) for k in path]): v for path, v in jscales}
        assert optimizer.make_layer_decay_scales(model, pcfg) == ref_scales

    tx = joptim.construct_optimizer(params, cfg)
    opt_state = tx.init(params)

    @jax.jit
    def update(g, opt_state, params, lr):
        updates, opt_state = tx.update(g, joptim.set_lr(opt_state, lr), params)
        return optax.apply_updates(params, updates), opt_state

    for g, lr in zip(grads, lrs):
        params, opt_state = update(g, opt_state, params, lr)

        for name, value in state_dict_from_jax(jax.tree_util.tree_map(np.asarray, g)).items():
            named[name].grad = value
        optimizer.set_lr(opt, lr)
        opt.step()

    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    got = model.state_dict()
    moved = 0
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
        moved += not torch.equal(got[name], state_dict_from_jax(tiny_params)[name])
    assert moved == len(ref)


@pytest.mark.parametrize("shapes", [[(3, 4), (5,), (2, 2, 2)], [(768, 3072), (96,)]],
                         ids=["small", "mlp_weight"])
def test_grad_norm_is_optax_global_norm(shapes):
    rng = np.random.default_rng(3)
    tensors = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ref = optax.global_norm([jnp.asarray(t) for t in tensors])
    out = optimizer.global_norm(torch.from_numpy(t) for t in tensors)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


def test_norms_keep_float64():
    """The float64 step's norms stay float64 (the repair of the contrastive
    steps' float64 residue, PERF.md section 6): ``global_norm`` of float64
    tensors is float64 and exact, of float32 ones float32 as before; LARS's
    trust ratio sums its norms in float64 and comes back in the update's
    dtype."""
    rng = np.random.default_rng(4)
    arrays = [rng.normal(size=s) for s in [(300, 700), (50,)]]
    exact = np.sqrt(sum(float(np.square(a).sum()) for a in arrays))
    out = optimizer.global_norm(torch.from_numpy(a) for a in arrays)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(float(out), exact, rtol=1e-14)
    out32 = optimizer.global_norm(torch.from_numpy(a.astype(np.float32)) for a in arrays)
    assert out32.dtype == torch.float32
    np.testing.assert_allclose(float(out32), exact, rtol=1e-6)

    p, u = (torch.from_numpy(a.astype(np.float32)) for a in
            (rng.normal(size=(2048, 1000)), 1e-3 * rng.normal(size=(2048, 1000))))
    ratio = optimizer._trust_ratio(p, u)
    want = np.linalg.norm(p.double().numpy()) / np.linalg.norm(u.double().numpy())
    assert ratio.dtype == torch.float32
    assert float(ratio) == float(np.float32(want))


def test_batchnorm_eval_of_float64_input_is_float64():
    """Eval mode reads the float32 running statistics in float64 for a
    float64 input (the momentum encoder's key forward of MoCo and BYOL):
    the output is float64's to its own rounding, where a float32 rsqrt of
    the statistics moved it by 6e-8."""
    from pmv_tpu_torch.models.batchnorm import BatchNorm

    gen = torch.Generator().manual_seed(0)
    for splits in (0, 2):
        bn = BatchNorm(16, num_splits=splits).eval()
        with torch.no_grad():
            bn.running_mean.normal_(generator=gen)
            bn.running_var.uniform_(0.5, 1.5, generator=gen)
            bn.weight.uniform_(0.5, 1.5, generator=gen)
        x = torch.randn(4, 3, 16, generator=gen, dtype=torch.float64)
        m, v = bn.running_mean.double(), bn.running_var.double()
        if splits:
            m, v = m.reshape(splits, 16), v.reshape(splits, 16)
            m, v = m.mean(0), (v + m.square()).mean(0) - m.mean(0).square()
        want = (x - m) / torch.sqrt(v + 1e-5) * bn.weight.double() + bn.bias.double()
        with torch.no_grad():
            got = bn(x)
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, want, atol=1e-13, rtol=1e-13)
