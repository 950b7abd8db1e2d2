"""Shared helpers of the pmv_tpu_torch parity tests (tests/test_torch_port_*).

Inputs are made with numpy from a seed and handed to both packages; weights
go from the JAX parameter tree to the port through ``state_dict_from_jax``.
This module imports no JAX at import time, so that the CUDA tests, which
run where JAX is not installed, can use it.
"""

import numpy as np
import pytest
import torch
import yaml

import pmv_tpu_torch.config as port_config
from pmv_tpu_torch.ops import depthwise as port_depthwise


def port_cfg(jax_cfg):
    """The port's CfgNode holding the same values as a pmv_tpu config."""
    return port_config.CfgNode(yaml.safe_load(jax_cfg.dump()))


def numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def random_params(params, seed):
    """Every parameter redrawn with numpy, large enough that rel-pos tables,
    pool kernels and norms move the outputs (norm scales near 1)."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, p):
        noise = rng.normal(size=tuple(p.shape)).astype(np.float32)
        return 1.0 + 0.1 * noise if str(path[-1].key) == "scale" else 0.3 * noise

    return jax.tree_util.tree_map_with_path(draw, params)


def random_batch_stats(batch_stats, seed):
    """BatchNorm statistics redrawn with numpy: means near 0, variances in
    [0.5, 1.5]."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, p):
        if str(path[-1].key) == "var":
            return rng.uniform(0.5, 1.5, size=tuple(p.shape)).astype(np.float32)
        return (0.3 * rng.normal(size=tuple(p.shape))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, batch_stats)


def to_np(t):
    return t.detach().float().numpy()


@pytest.fixture
def cuda_device():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 through chip_smoke.py)")
    return torch.device("cuda")


@pytest.fixture
def depthwise_calls(monkeypatch):
    """Counts the model's calls into ops.depthwise3x3x3. On the CPU the
    wrapper takes the plain version and launches nothing, so its launch
    count cannot show the path was taken; this spy can."""
    from pmv_tpu_torch.models import common

    calls = []

    def spy(x, w):
        calls.append(tuple(x.shape))
        return port_depthwise.depthwise3x3x3(x, w)

    monkeypatch.setattr(common, "depthwise3x3x3", spy)
    return calls


# ----------------------------------------------------------------------------
# The JAX package's random draws, as the port's "sample" outputs. Each helper
# repeats the key splits of the JAX function it names, so that the port's
# "apply" can be fed exactly what JAX drew.


def jax_rand_augment_draws(config_str, key, groups):
    """`RandAugment.apply_batch` (`rand_augment.py:457-484`): one key per
    group, one per layer, then (choice, magnitude, sign)."""
    import jax
    import jax.numpy as jnp
    from pmv_tpu.data import rand_augment as jra
    from pmv_tpu_torch.data.rand_augment import RandAugmentDraws

    ra = jra.RandAugment(config_str)
    op_idx, mags, negs = [], [], []
    for key_g in jax.random.split(key, groups):
        for layer_key in jax.random.split(key_g, ra.num_layers):
            k_choice, k_mag, k_sign = jax.random.split(layer_key, 3)
            op_idx.append(int(jax.random.randint(k_choice, (), 0, len(ra.ops))))
            m = ra.magnitude
            if ra.magnitude_std > 0:
                m = m + ra.magnitude_std * jax.random.normal(k_mag)
            mags.append(np.float32(jnp.clip(m, 0.0, jra._LEVEL_DENOM)))
            negs.append(bool(jax.random.uniform(k_sign) < 0.5))
    shape = (groups, ra.num_layers)
    return RandAugmentDraws(
        torch.tensor(op_idx).reshape(shape),
        torch.tensor(np.array(mags, np.float32)).reshape(shape),
        torch.tensor(negs).reshape(shape),
    )


def jax_erasing_draws(key, shape, probability, mode="pixel", min_area=0.02,
                      max_area=1 / 3, min_aspect=0.3):
    """`random_erasing` (`random_erasing.py:34-58`): six keys."""
    import math

    import jax
    import jax.numpy as jnp
    from pmv_tpu_torch.data.random_erasing import ErasingDraws

    b, _, h, w, _ = shape
    max_aspect = 1 / min_aspect
    keys = jax.random.split(key, 6)
    log_ratio = (math.log(min_aspect), math.log(max_aspect))
    apply = jax.random.uniform(keys[0], (b,)) < probability
    target_area = jax.random.uniform(keys[1], (b,), minval=min_area, maxval=max_area) * (h * w)
    aspect = jnp.exp(jax.random.uniform(keys[2], (b,), minval=log_ratio[0], maxval=log_ratio[1]))
    eh = jnp.clip(jnp.round(jnp.sqrt(target_area * aspect)), 1, h).astype(jnp.int32)
    ew = jnp.clip(jnp.round(jnp.sqrt(target_area / aspect)), 1, w).astype(jnp.int32)
    top = (jax.random.uniform(keys[3], (b,)) * (h - eh + 1)).astype(jnp.int32)
    left = (jax.random.uniform(keys[4], (b,)) * (w - ew + 1)).astype(jnp.int32)
    fill = None
    if mode == "pixel":
        fill = torch.from_numpy(np.array(jax.random.normal(keys[5], tuple(shape))))

    def t(a):
        return torch.from_numpy(np.array(a))

    return ErasingDraws(t(apply), t(top).long(), t(left).long(), t(eh).long(), t(ew).long(), fill)


def jax_mixup_draws(mixup, key, height, width):
    """`MixUp.__call__` (`mixup.py:67-94`) for a pmv_tpu MixUp: five keys,
    the box centre from the last."""
    import jax
    from pmv_tpu_torch.data.mixup import MixUpDraws

    k_apply, k_switch, k_mix, k_cut, k_box = jax.random.split(key, 5)
    use_cutmix = mixup.cutmix_alpha > 0.0 and bool(
        jax.random.uniform(k_switch) < mixup.switch_prob
    )
    lam_mix = lam_cut = np.float32(1.0)
    if mixup.mixup_alpha > 0.0:
        lam_mix = np.float32(jax.random.beta(k_mix, mixup.mixup_alpha, mixup.mixup_alpha))
    if mixup.cutmix_alpha > 0.0:
        lam_cut = np.float32(jax.random.beta(k_cut, mixup.cutmix_alpha, mixup.cutmix_alpha))
    ky, kx = jax.random.split(k_box)
    cy = int(jax.random.randint(ky, (), 0, height))
    cx = int(jax.random.randint(kx, (), 0, width))
    apply = bool(jax.random.uniform(k_apply) < mixup.mix_prob)
    return MixUpDraws(apply, use_cutmix, torch.tensor(lam_mix), torch.tensor(lam_cut), cy, cx)


def jax_dropout_masks(jmodel, variables, x, key, **kwargs):
    """The keep masks (bool, in call order) that the ``nn.Dropout`` modules of
    ``jmodel`` draw in one train-mode apply on an input of ``x``'s shape
    with ``rngs={"dropout": key}``, as the JAX train step applies it. A mask
    depends on the key, the module's path and the shape, not on the values:
    each Dropout is called once, on ones, and its output read."""
    import flax.linen as fnn
    import jax.numpy as jnp

    masks = []

    def interceptor(next_fun, args, call_kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            kept = next_fun(jnp.ones_like(args[0]), *args[1:], **call_kwargs)
            masks.append(np.asarray(kept != 0))
            return args[0] * kept
        return next_fun(*args, **call_kwargs)

    with fnn.intercept_methods(interceptor):
        jmodel.apply(variables, jnp.zeros(x.shape, jnp.float32), train=True,
                     mutable=["batch_stats"], rngs={"dropout": key}, **kwargs)
    return masks


def jax_train_draws(cfg, rng, step, shape):
    """The draws of the JAX train step (`steps.py:197-199`) at ``step``
    for a batch of ``shape``: RandAugment and erasing from the preprocess
    key, MixUp from the mixup key. DropPath's and the head dropout's keys
    come from flax's module RNG streams and are not repeated here: tests
    run DropPath at rate 0, and read the head's masks off the model with
    ``jax_dropout_masks`` under ``jax_dropout_key``."""
    import jax
    from pmv_tpu.data.mixup import MixUp
    from pmv_tpu_torch.data.rand_augment import num_groups

    k_pre, k_mix, _ = jax.random.split(jax.random.fold_in(rng, step), 3)
    draws = {}
    key = k_pre
    if cfg.AUG.ENABLE and cfg.AUG.AA_TYPE:
        k_ra, key = jax.random.split(key)
        groups = num_groups(shape[0], cfg.AUG.RA_GROUPS)
        draws["rand_augment"] = jax_rand_augment_draws(cfg.AUG.AA_TYPE, k_ra, groups)
    if cfg.AUG.ENABLE and cfg.AUG.RE_PROB > 0:
        k_re, key = jax.random.split(key)
        draws["erasing"] = jax_erasing_draws(k_re, shape, cfg.AUG.RE_PROB, cfg.AUG.RE_MODE)
    if cfg.MIXUP.ENABLE:
        mixup = MixUp(
            mixup_alpha=cfg.MIXUP.ALPHA, cutmix_alpha=cfg.MIXUP.CUTMIX_ALPHA,
            mix_prob=cfg.MIXUP.PROB, switch_prob=cfg.MIXUP.SWITCH_PROB,
            label_smoothing=cfg.MIXUP.LABEL_SMOOTH_VALUE,
            num_classes=cfg.MODEL.NUM_CLASSES,
        )
        draws["mixup"] = jax_mixup_draws(mixup, k_mix, shape[2], shape[3])
    return draws


def jax_dropout_key(rng, step):
    """The dropout key of the JAX train step at ``step`` (`steps.py:197`)."""
    import jax

    return jax.random.split(jax.random.fold_in(rng, step), 3)[2]
