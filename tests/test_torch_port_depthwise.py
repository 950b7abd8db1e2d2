"""pmv_tpu_torch.ops.depthwise against the JAX package's depthwise conv.

The plain version (the CPU path) is held against XLA's grouped conv and the
Pallas kernel in interpret mode. The CUDA kernel is held against the plain
version in tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.ops import depthwise_pallas
from pmv_tpu_torch.ops.depthwise import depthwise3x3x3, depthwise3x3x3_plain


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
