"""pmv_tpu_torch.models.attention against pmv_tpu.models.attention.

AttentionPool, MultiScaleAttention and MultiScaleBlock at tiny widths, in
float32 on the CPU: the same numpy inputs and weights (carried over by
``state_dict_from_jax``) go through both. Tolerance atol 2e-4, rtol 1e-4
(float32 sums in another order; softmax over a few hundred keys).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.models import attention as jattn
from pmv_tpu_torch.models import attention as tattn
from pmv_tpu_torch.models.common import LayerNorm
from pmv_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax
from torch_port_util import depthwise_calls, random_params, to_np  # noqa: F401

ATOL, RTOL = 2e-4, 1e-4


def _tokens(b, thw, dim, cls, seed, heads=None):
    n = int(np.prod(thw)) + (1 if cls else 0)
    shape = (b, n, dim) if heads is None else (b, n, heads, dim)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


POOL_CASES = {
    "cls_stride1_333": dict(kernel=(3, 3, 3), stride=(1, 1, 1), cls=True, thw=(3, 4, 5)),
    "nocls_stride1_333": dict(kernel=(3, 3, 3), stride=(1, 1, 1), cls=False, thw=(3, 4, 5)),
    "cls_strided_q": dict(kernel=(3, 3, 3), stride=(1, 2, 2), cls=True, thw=(2, 6, 4)),
    "nocls_kv_stride4": dict(kernel=(3, 3, 3), stride=(1, 4, 4), cls=False, thw=(2, 8, 8)),
    "max_cls": dict(kernel=(3, 3, 3), stride=(1, 2, 2), cls=True, thw=(2, 6, 4), mode="max"),
    "avg_nocls": dict(kernel=(1, 3, 3), stride=(1, 2, 2), cls=False, thw=(2, 5, 4), mode="avg"),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_attention_pool_matches_jax(case, depthwise_calls):  # noqa: F811
    spec = POOL_CASES[case]
    heads, c = 2, 8
    mode = spec.get("mode", "conv")
    x = _tokens(2, spec["thw"], c, spec["cls"], seed=1, heads=heads)
    jmod = jattn.AttentionPool(
        kernel=spec["kernel"], stride=spec["stride"], mode=mode,
        has_cls_embed=spec["cls"],
    )
    init = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), spec["thw"])
    params = random_params(init.get("params", {}), seed=2)
    jout, jthw = jmod.apply({"params": params}, jnp.asarray(x), spec["thw"])

    pool = tattn.AttentionPool(spec["kernel"], spec["stride"], mode, spec["cls"], c)
    norm = None
    if mode == "conv":
        norm = LayerNorm(c)
        sd = state_dict_from_jax(params)
        pool.load_state_dict({"weight": sd["weight"]}, strict=True)
        norm.load_state_dict({"weight": sd["norm.weight"], "bias": sd["norm.bias"]})
    out, thw = pool(torch.from_numpy(x), spec["thw"], norm)

    assert tuple(thw) == tuple(jthw)
    np.testing.assert_allclose(to_np(out), np.asarray(jout), atol=ATOL, rtol=RTOL)
    kernel_path = mode == "conv" and spec["stride"] == (1, 1, 1)
    assert len(depthwise_calls) == (1 if kernel_path else 0)


# input_size is the construction (landscape) grid; thw the runtime grid.
MSA_CASES = {
    "cls_q333_kv122": dict(
        cls=True, input_size=(2, 4, 4), thw=(2, 4, 4),
        stride_q=(1, 1, 1), stride_kv=(1, 2, 2), hw_switch=False,
    ),
    "nocls_q333_kv144_sparse": dict(
        cls=False, input_size=(2, 8, 8), thw=(2, 8, 8),
        stride_q=(1, 1, 1), stride_kv=(1, 4, 4), hw_switch=False,
    ),
    "cls_strided_q": dict(
        cls=True, input_size=(2, 4, 4), thw=(2, 4, 4),
        stride_q=(1, 2, 2), stride_kv=(1, 1, 1), hw_switch=False,
    ),
    "portrait_hw_switch": dict(
        cls=True, input_size=(2, 4, 6), thw=(2, 6, 4),
        stride_q=(1, 1, 1), stride_kv=(1, 2, 2), hw_switch=True,
    ),
    "portrait_resized_tables": dict(
        cls=True, input_size=(2, 4, 6), thw=(2, 6, 4),
        stride_q=(1, 1, 1), stride_kv=(1, 2, 2), hw_switch=False,
    ),
    "separate_qkv": dict(
        cls=True, input_size=(2, 4, 4), thw=(2, 4, 4),
        stride_q=(1, 1, 1), stride_kv=(1, 2, 2), hw_switch=False,
        separate_qkv=True,
    ),
}


@pytest.mark.parametrize("case", sorted(MSA_CASES))
def test_multiscale_attention_matches_jax(case, depthwise_calls):  # noqa: F811
    spec = MSA_CASES[case]
    dim, dim_out, heads = 8, 16, 2
    kw = dict(
        num_heads=heads, input_size=spec["input_size"], qkv_bias=True,
        kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), stride_q=spec["stride_q"],
        stride_kv=spec["stride_kv"], has_cls_embed=spec["cls"], mode="conv",
        rel_pos_spatial=True, rel_pos_temporal=True, residual_pooling=True,
        hw_switch=spec["hw_switch"], separate_qkv=spec.get("separate_qkv", False),
    )
    x = _tokens(2, spec["thw"], dim, spec["cls"], seed=3)
    jmod = jattn.MultiScaleAttention(dim_out=dim_out, dtype=jnp.float32, **kw)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), spec["thw"])["params"]
    params = random_params(params, seed=4)
    jout, jthw = jmod.apply({"params": params}, jnp.asarray(x), spec["thw"])

    tmod = tattn.MultiScaleAttention(dim, dim_out, **kw)
    load_jax_params(tmod, params)
    out, thw = tmod(torch.from_numpy(x), spec["thw"])

    assert tuple(thw) == tuple(jthw)
    np.testing.assert_allclose(to_np(out), np.asarray(jout), atol=ATOL, rtol=RTOL)
    n_stride1 = (spec["stride_q"] == (1, 1, 1)) + 2 * (spec["stride_kv"] == (1, 1, 1))
    assert len(depthwise_calls) == n_stride1


@pytest.mark.parametrize("dim_mul_in_att", [True, False])
def test_multiscale_block_matches_jax(dim_mul_in_att, depthwise_calls):  # noqa: F811
    dim, dim_out, heads = 8, 16, 2
    thw = (2, 4, 4)
    kw = dict(
        num_heads=heads, input_size=thw, qkv_bias=True,
        kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), stride_q=(1, 2, 2),
        stride_kv=(1, 1, 1), has_cls_embed=True, mode="conv",
        rel_pos_spatial=True, rel_pos_temporal=True, residual_pooling=True,
        dim_mul_in_att=dim_mul_in_att,
    )
    x = _tokens(2, thw, dim, True, seed=5)
    jmod = jattn.MultiScaleBlock(dim=dim, dim_out=dim_out, dtype=jnp.float32, **kw)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), thw)["params"]
    params = random_params(params, seed=6)
    jout, jthw = jmod.apply({"params": params}, jnp.asarray(x), thw)

    tmod = tattn.MultiScaleBlock(dim, dim_out, **kw).eval()
    load_jax_params(tmod, params)
    out, out_thw = tmod(torch.from_numpy(x), thw)

    assert tuple(out_thw) == tuple(jthw)
    np.testing.assert_allclose(to_np(out), np.asarray(jout), atol=ATOL, rtol=RTOL)
    assert len(depthwise_calls) == 2  # the stride-1 K and V pools


@pytest.mark.parametrize("size", [9, 15, 27, 4])
def test_interpolate_rel_pos_matches_jax_resize(size):
    """Up- and downsampling (JAX antialiases the latter). The weights are
    computed in float64 here and in float32 by JAX, hence 1e-5."""
    table = np.random.default_rng(7).normal(size=(15, 8)).astype(np.float32)
    ref = np.asarray(jattn.interpolate_rel_pos(jnp.asarray(table), size))
    out = tattn.interpolate_rel_pos(torch.from_numpy(table), size)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
