"""The port's on-device augmentation against the JAX package's.

"Apply" is held against the JAX function on the same parameters, drawn from
JAX keys by the helpers in torch_port_util (which repeat the JAX key
splits): each of the 15 RandAugment ops, MixUp (mixup, cutmix and no mix),
random erasing and DropPath. "Sample" draws with torch generators, so it is
held by its distributions: lam's mean and variance, the cutmix share, the
erase rate, op-index uniformity and the DropPath and Dropout keep rates.

Images are float32 in [0, 255]. The geometric ops sum two bilinear taps in
another order than XLA, so they agree to 2e-3 of a grey level; the integer
ops (equalize, posterize) agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.data import mixup as jmixup
from pmv_tpu.data import rand_augment as jra
from pmv_tpu.data import random_erasing as jre
from pmv_tpu.models import common as jcommon
from pmv_tpu_torch.data import mixup, rand_augment, random_erasing
from pmv_tpu_torch.models.common import Dropout, DropPath
from torch_port_util import jax_erasing_draws, jax_mixup_draws, jax_rand_augment_draws

OPS = [name for name, _, _ in jra._make_ops({})]
EXACT = {"Equalize", "Posterize", "Invert", "Solarize"}


def _image(seed, shape=(2, 12, 10, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)


def test_op_table_matches_jax():
    assert [name for name, _, _ in rand_augment._make_ops({})] == OPS
    assert rand_augment.parse_rand_augment_config(
        "rand-m7-n4-mstd0.5-inc1"
    ) == jra.parse_rand_augment_config("rand-m7-n4-mstd0.5-inc1")


@pytest.mark.parametrize("magnitude", [3.0, 9.5])
@pytest.mark.parametrize("op", OPS)
def test_rand_augment_op_matches_jax(op, magnitude):
    idx = OPS.index(op)
    img = _image(idx)
    _, jfn, jlvl = jra._make_ops({})[idx]
    key = jax.random.PRNGKey(idx + int(magnitude))
    m = jnp.float32(magnitude)
    ref = np.asarray(jfn(jnp.asarray(img), jlvl(key, m)).astype(jnp.float32))
    negate = bool(jax.random.uniform(key) < 0.5)
    ra = rand_augment.RandAugment("rand-m7-n1-mstd0.5-inc1")
    out = ra.apply_op(torch.from_numpy(img), idx, torch.tensor(magnitude), negate)
    assert out.dtype == torch.float32 and out.shape == img.shape
    if op in EXACT:
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-3, rtol=0)


@pytest.mark.parametrize("groups", [0, 1])
def test_rand_augment_batch_matches_jax(groups):
    """Per-clip chains (RA_GROUPS 0) and one shared chain, two layers:
    the draws JAX makes inside apply_batch, applied by the port."""
    x = _image(3, (2, 2, 12, 10, 3))
    key = jax.random.PRNGKey(11)
    jgroups = 1 << 30 if groups <= 0 else groups
    config = "rand-m9-n2-mstd0.5-inc1"
    ref = jra.RandAugment(config).apply_batch(key, jnp.asarray(x), groups=jgroups)
    n = rand_augment.num_groups(2, groups)
    draws = jax_rand_augment_draws(config, key, n)
    out = rand_augment.RandAugment(config).apply_batch(torch.from_numpy(x), draws)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=0)


@pytest.mark.parametrize(
    "mode, kwargs",
    [
        ("mixup", dict(mixup_alpha=0.8, cutmix_alpha=0.0)),
        ("cutmix", dict(mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=1.0)),
        ("no_mix", dict(mixup_alpha=0.8, cutmix_alpha=1.0, mix_prob=0.0)),
    ],
)
def test_mixup_apply_matches_jax(mode, kwargs):
    kwargs = dict(kwargs, label_smoothing=0.1, num_classes=7)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 2, 12, 10, 3)).astype(np.float32)
    labels = np.array([1, 5, 5, 2])
    key = jax.random.PRNGKey(5)
    jm = jmixup.MixUp(**kwargs)
    ref_x, ref_t = jm(key, jnp.asarray(x), jnp.asarray(labels))
    draws = jax_mixup_draws(jm, key, 12, 10)
    assert (draws.apply, draws.use_cutmix) == {
        "mixup": (True, False), "cutmix": (True, True), "no_mix": (False, True),
    }[mode]
    out_x, out_t = mixup.MixUp(**kwargs).apply(
        torch.from_numpy(x), torch.from_numpy(labels), draws
    )
    np.testing.assert_allclose(out_x.numpy(), np.asarray(ref_x), atol=1e-6, rtol=0)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_t), atol=1e-7, rtol=0)


def test_mixup_target_matches_jax():
    labels = np.array([0, 3, 3, 1, 2])
    for lam in (1.0, np.float32(0.37)):
        ref = jmixup.mixup_target(jnp.asarray(labels), 4, lam, 0.1)
        out = mixup.mixup_target(torch.from_numpy(labels), 4, lam, 0.1)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["pixel", "const"])
def test_random_erasing_apply_matches_jax(mode):
    x = np.random.default_rng(6).normal(size=(6, 2, 12, 10, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = jre.random_erasing(key, jnp.asarray(x), probability=0.7, mode=mode)
    draws = jax_erasing_draws(key, x.shape, 0.7, mode)
    assert 0 < int(draws.apply.sum()) < 6
    out = random_erasing.random_erasing(torch.from_numpy(x), draws)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_drop_path_apply_matches_jax():
    x = np.random.default_rng(8).normal(size=(16, 5, 4)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    rate = 0.3
    ref = jcommon.drop_path(jnp.asarray(x), rate, False, key)
    mask = jax.random.bernoulli(key, 1.0 - rate, (16, 1, 1))
    assert 0 < int(mask.sum()) < 16
    module = DropPath(rate).train()
    out = module(torch.from_numpy(x), torch.from_numpy(np.array(mask)).reshape(16))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    assert torch.equal(module.eval()(torch.from_numpy(x)), torch.from_numpy(x))
    with pytest.raises(ValueError, match="keep mask"):
        module.train()(torch.from_numpy(x))


def test_dropout_apply_matches_flax():
    import flax.linen as fnn

    x = np.random.default_rng(10).normal(size=(4, 24)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = fnn.Dropout(0.5).apply({}, jnp.asarray(x), deterministic=False, rng=key)
    mask = np.asarray(jax.random.bernoulli(key, 0.5, x.shape))
    module = Dropout(0.5).train()
    out = module(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    gen = torch.Generator().manual_seed(4)
    assert abs(float(module.sample((200, 100), gen).mean()) - 0.5) < 0.01
    with pytest.raises(ValueError, match="keep mask"):
        module(torch.from_numpy(x))


# ------------------------------------------------------- sampling (port only)


def test_mixup_sampling_distribution():
    gen = torch.Generator().manual_seed(0)
    m = mixup.MixUp(mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=0.5, mix_prob=0.8)
    draws = [m.sample(224, 160, gen) for _ in range(3000)]
    lam = np.array([float(d.lam_mix) for d in draws])
    lam_cut = np.array([float(d.lam_cut) for d in draws])
    # Beta(a, a): mean 1/2, variance 1 / (4 (2a + 1)).
    assert abs(lam.mean() - 0.5) < 0.02 and abs(lam_cut.mean() - 0.5) < 0.02
    assert abs(lam.var() - 1 / (4 * 2.6)) < 0.01
    assert abs(lam_cut.var() - 1 / 12) < 0.01
    assert abs(np.mean([d.use_cutmix for d in draws]) - 0.5) < 0.04
    assert abs(np.mean([d.apply for d in draws]) - 0.8) < 0.03
    cy = np.array([d.cy for d in draws])
    assert cy.min() == 0 and cy.max() == 223 and abs(cy.mean() - 111.5) < 5


def test_erasing_sampling_distribution():
    gen = torch.Generator().manual_seed(1)
    d = random_erasing.sample_random_erasing((4000, 1, 56, 40, 3), gen, mode="const")
    assert abs(float(d.apply.float().mean()) - 0.25) < 0.02
    area = (d.height * d.width).float() / (56 * 40)
    assert 0.01 < float(area.min()) and float(area.max()) < 0.5
    assert bool(((d.top + d.height) <= 56).all() and ((d.left + d.width) <= 40).all())


def test_rand_augment_sampling_distribution():
    gen = torch.Generator().manual_seed(2)
    ra = rand_augment.RandAugment("rand-m7-n4-mstd0.5-inc1")
    d = ra.sample(3000, gen)
    counts = torch.bincount(d.op_idx.flatten(), minlength=15).numpy()
    expected = d.op_idx.numel() / 15
    assert np.all(np.abs(counts - expected) < 0.1 * expected)
    assert abs(float(d.magnitude.mean()) - 7.0) < 0.02
    assert abs(float(d.magnitude.std()) - 0.5) < 0.02
    assert abs(float(d.negate.float().mean()) - 0.5) < 0.02


def test_drop_path_keep_rate():
    gen = torch.Generator().manual_seed(3)
    mask = DropPath(0.2).sample(20000, gen)
    assert set(mask.unique().tolist()) == {0.0, 1.0}
    assert abs(float(mask.mean()) - 0.8) < 0.01
    assert DropPath(0.0).sample(8, gen) is None
