"""pmv_tpu_torch.ops.depthwise against the JAX package's depthwise conv.

The plain versions (the CPU path) are held against XLA's grouped conv and
the Pallas kernel in interpret mode: the forward, and the autograd
Function's dx and dw against ``jax.grad`` of the custom_vjp (float32, atol
1e-4). The CUDA kernels are held against the plain versions in
tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.ops import depthwise_pallas
from pmv_tpu_torch.ops.depthwise import (
    depthwise3x3x3,
    depthwise3x3x3_plain,
    depthwise3x3x3_wgrad,
    depthwise3x3x3_wgrad_plain,
)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, shape[-1])) * 0.1).astype(np.float32)
    return x, w


def _xla_dw(x, w):
    c = x.shape[-1]
    return jax.lax.conv_general_dilated(
        x, w.reshape(3, 3, 3, 1, c), (1, 1, 1), [(1, 1)] * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        feature_group_count=c,
    )


def test_plain_matches_xla_grouped_conv():
    x, w = _inputs((2, 3, 9, 7, 16), 0)
    ref = np.asarray(_xla_dw(jnp.asarray(x), jnp.asarray(w)))
    out = depthwise3x3x3_plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_plain_matches_pallas_interpret():
    """The TPU kernel itself, in interpret mode, with H tiled (tile_h=4)."""
    x, w = _inputs((2, 3, 9, 7, 16), 1)
    old = depthwise_pallas.INTERPRET_OVERRIDE
    depthwise_pallas.INTERPRET_OVERRIDE = True
    try:
        ref = np.asarray(
            depthwise_pallas.depthwise3x3x3_fwd(
                jnp.asarray(x), jnp.asarray(w), tile_h=4
            )
        )
    finally:
        depthwise_pallas.INTERPRET_OVERRIDE = old
    out = depthwise3x3x3_plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_plain_keeps_dtype_and_accumulates_in_f32():
    x, w = _inputs((1, 2, 5, 4, 8), 2)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    out = depthwise3x3x3_plain(xb, wb)
    assert out.dtype == torch.bfloat16
    ref = depthwise3x3x3_plain(xb.float(), wb.float()).bfloat16()
    assert torch.equal(out, ref)


def test_wrapper_on_cpu_takes_plain_and_launches_nothing():
    x, w = _inputs((1, 2, 4, 6, 8), 3)
    before = depthwise3x3x3.launches
    out = depthwise3x3x3(torch.from_numpy(x), torch.from_numpy(w))
    assert depthwise3x3x3.launches == before
    ref = depthwise3x3x3_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(out, ref)


def test_wrapper_refuses_other_devices():
    x = torch.empty((1, 1, 2, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        depthwise3x3x3(x, torch.empty((3, 3, 3, 8), device="meta"))


def _port_grads(x, w, g):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    depthwise3x3x3(xt, wt).backward(torch.from_numpy(g))
    return xt.grad.numpy(), wt.grad.numpy()


def _jax_grads(fn, x, w, g):
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("shape", [(2, 3, 9, 7, 16), (1, 4, 5, 6, 8)])
def test_grads_match_pallas_custom_vjp_interpret(shape):
    """dx and dw against the JAX package's custom_vjp, whose forward and dx
    run the Pallas kernel in interpret mode."""
    x, w = _inputs(shape, 4)
    g = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    old = depthwise_pallas.INTERPRET_OVERRIDE
    depthwise_pallas.INTERPRET_OVERRIDE = True
    try:
        ref_dx, ref_dw = _jax_grads(depthwise_pallas.depthwise3x3x3, x, w, g)
    finally:
        depthwise_pallas.INTERPRET_OVERRIDE = old
    dx, dw = _port_grads(x, w, g)
    np.testing.assert_allclose(dx, ref_dx, atol=1e-4, rtol=0)
    np.testing.assert_allclose(dw, ref_dw, atol=1e-4, rtol=0)


def test_grads_match_xla_grouped_conv_grads():
    x, w = _inputs((2, 3, 6, 5, 16), 6)
    g = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    ref_dx, ref_dw = _jax_grads(_xla_dw, x, w, g)
    dx, dw = _port_grads(x, w, g)
    np.testing.assert_allclose(dx, ref_dx, atol=1e-4, rtol=0)
    np.testing.assert_allclose(dw, ref_dw, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgrad_plain_matches_custom_vjp_bwd(dtype):
    """depthwise3x3x3_wgrad_plain against the dw of ``_bwd`` (27 shifted
    float32 reductions, cast to w.dtype)."""
    x, w = _inputs((2, 3, 7, 5, 8), 8)
    g = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    _, ref_dw = depthwise_pallas._bwd(
        (jnp.asarray(x, jdt), jnp.asarray(w, jdt)), jnp.asarray(g, jdt)
    )
    tdt = getattr(torch, dtype)
    dw = depthwise3x3x3_wgrad_plain(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    )
    assert dw.dtype == tdt and dw.shape == (3, 3, 3, 8)
    # float32: sums in another order; bfloat16: one output rounding apart.
    tol = dict(atol=1e-4, rtol=0) if dtype == "float32" else dict(atol=0.0, rtol=8e-3)
    np.testing.assert_allclose(
        dw.float().numpy(), np.asarray(ref_dw.astype(jnp.float32)), **tol
    )


def test_grad_wrappers_on_cpu_launch_nothing():
    x, w = _inputs((1, 2, 4, 6, 8), 10)
    k1, wg = depthwise3x3x3.launches, depthwise3x3x3_wgrad.launches
    _port_grads(x, w, np.ones_like(x))
    dw = depthwise3x3x3_wgrad(torch.from_numpy(x), torch.from_numpy(x))
    assert (depthwise3x3x3.launches, depthwise3x3x3_wgrad.launches) == (k1, wg)
    assert torch.equal(
        dw, depthwise3x3x3_wgrad_plain(torch.from_numpy(x), torch.from_numpy(x))
    )
