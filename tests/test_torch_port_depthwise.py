"""pmv_tpu_torch.ops.depthwise against the JAX package's depthwise conv.

The plain versions (the CPU path) are held against XLA's grouped conv and
the Pallas kernel in interpret mode: the forward, and the autograd
Function's dx and dw against ``jax.grad`` of the custom_vjp (float32, atol
1e-4). The CUDA kernels are held against the plain versions in
tests/test_torch_port_cuda.py; their launch plans (at the padded channel
counts where C is not a multiple of 8), the channel pad the wrappers put
around them on the card (``channel_padded``, driven here with the plain
versions), and the build's library names, are checked here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.ops import depthwise_pallas
from pmv_tpu_torch.ops.depthwise import (
    CHANNEL_MULTIPLE,
    H100_SMS,
    MVIT_POOL_SHAPES,
    MVIT_PORTRAIT_POOL_SHAPES,
    MVIT_RECT_POOL_SHAPES,
    MVIT_RECT_TRAIN_POOL_SHAPES,
    ODD_SHAPES,
    UNIFORMER_DPE_SHAPES,
    UNIFORMER_PORTRAIT_DPE_SHAPES,
    UNIFORMER_RECT_DPE_SHAPES,
    UNIFORMER_TRAIN_DPE_SHAPES,
    X3D_DW_SHAPES,
    X3D_PORTRAIT_DW_SHAPES,
    X3D_RECT_DW_SHAPES,
    X3D_TEST_DW_SHAPES,
    SMEM_PER_BLOCK,
    channel_padded,
    depthwise3x3x3,
    depthwise3x3x3_plain,
    depthwise3x3x3_wgrad,
    depthwise3x3x3_wgrad_plain,
    plan_forward,
    plan_wgrad,
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


@pytest.mark.parametrize("c", [12, 54, 108])
def test_channel_pad_with_the_plain_conv_equals_the_plain_conv(c):
    """The wrappers' pad-run-slice around the plain versions: forward, dx
    (the forward on the cotangent, weights flipped) and dw, exact, since a
    padded channel touches no other."""
    shape = (2, 3, 6, 5, c)
    x, w = (torch.from_numpy(a) for a in _inputs(shape, 11))
    g = torch.from_numpy(np.random.default_rng(12).normal(size=shape).astype(np.float32))
    w_flip = w.flip(0, 1, 2)
    for conv, a, b in ((depthwise3x3x3_plain, x, w), (depthwise3x3x3_plain, g, w_flip),
                       (depthwise3x3x3_wgrad_plain, x, g)):
        got = channel_padded(conv, a, b)
        assert got.is_contiguous() and got.shape[-1] == c
        assert torch.equal(got, conv(a, b))


def test_channel_pad_pads_to_the_kernels_multiple():
    """The conv sees C rounded up to a multiple of 8, zeros in the new
    channels of both inputs; at a multiple of 8 it sees the inputs as they
    are."""
    seen = []

    def conv(a, b):
        seen.append((a, b))
        return a

    x, w = torch.ones(1, 1, 2, 2, 54), torch.ones(3, 3, 3, 54)
    out = channel_padded(conv, x, w)
    a, b = seen[-1]
    assert a.shape[-1] == b.shape[-1] == 56 and out.shape[-1] == 54
    assert not a[..., 54:].any() and not b[..., 54:].any()
    x8 = torch.ones(1, 1, 2, 2, 16)
    assert channel_padded(conv, x8, w) is x8 and seen[-1][1] is w


@pytest.mark.parametrize("c", [12, 54])
def test_autograd_pads_each_tensor_once_a_layer(c, monkeypatch):
    """The autograd Function with the card's channel pad turned on, around
    the plain versions: x, w and the cotangent are each padded once (the
    forward keeps x and w padded for the backward), the convs see padded
    channels only, and the output, dx and dw equal the unpadded ones."""
    from pmv_tpu_torch.ops import depthwise as dw

    shape = (2, 3, 6, 5, c)
    x, w = _inputs(shape, 14)
    g = np.random.default_rng(15).normal(size=shape).astype(np.float32)
    want_out = depthwise3x3x3_plain(torch.from_numpy(x), torch.from_numpy(w))
    want_dx, want_dw = _port_grads(x, w, g)

    padded, seen = [], []
    pad = dw.pad_channels
    monkeypatch.setattr(dw, "_pads", lambda t: True)
    monkeypatch.setattr(dw, "pad_channels", lambda t: padded.append(t.shape) or pad(t))
    for name in ("depthwise3x3x3_plain", "depthwise3x3x3_wgrad_plain"):
        fn = getattr(dw, name)
        monkeypatch.setattr(dw, name, lambda a, b, fn=fn: seen.append(a.shape[-1]) or fn(a, b))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = depthwise3x3x3(xt, wt)
    out.backward(torch.from_numpy(g))
    assert padded == [shape, (3, 3, 3, c), shape]  # x, w, then the cotangent
    assert seen == [c + -c % CHANNEL_MULTIPLE] * 3  # forward, dx, dw
    assert out.shape == shape and xt.grad.shape == shape and wt.grad.shape == (3, 3, 3, c)
    assert torch.equal(out, want_out)
    assert np.array_equal(xt.grad.numpy(), want_dx) and np.array_equal(wt.grad.numpy(), want_dw)


def test_port_matches_pallas_at_x3d_channels():
    """At C = 54 (X3D-M's first stage) the port's CPU path equals the TPU
    kernel in interpret mode, which pads the channels to 128."""
    x, w = _inputs((2, 3, 9, 7, 54), 13)
    old = depthwise_pallas.INTERPRET_OVERRIDE
    depthwise_pallas.INTERPRET_OVERRIDE = True
    try:
        ref = np.asarray(depthwise_pallas.depthwise3x3x3_fwd(jnp.asarray(x), jnp.asarray(w)))
    finally:
        depthwise_pallas.INTERPRET_OVERRIDE = old
    out = depthwise3x3x3(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


# Launch plans of the CUDA kernels (they run only on the card; their tiling
# is worked out in Python and checked here), at the MViTv2-S 16x4 pool
# shapes of the 224^2 crop, of the PMV rect crop and of its transposes (at
# batch 8, and the rect ones at the PMV train step's batch of 16), at
# UniFormer-S 16x4's DPE shapes (the same three grids, at batch 8 and 16;
# C from 64), at X3D-M's channelwise-conv shapes (224^2, rect, transposed
# and 256^2 at batch 8; C = 54 and 108 at the 56 and 112 channels the
# wrappers pad them to), and at odd shapes.
def _padded(shape):
    return (*shape[:-1], shape[-1] + -shape[-1] % CHANNEL_MULTIPLE)


MAIN_SHAPES = [
    s for s, _ in MVIT_POOL_SHAPES + MVIT_RECT_POOL_SHAPES + MVIT_PORTRAIT_POOL_SHAPES
    + MVIT_RECT_TRAIN_POOL_SHAPES + UNIFORMER_DPE_SHAPES + UNIFORMER_RECT_DPE_SHAPES
    + UNIFORMER_PORTRAIT_DPE_SHAPES + UNIFORMER_TRAIN_DPE_SHAPES
] + list(dict.fromkeys(
    _padded(s) for s, _ in X3D_DW_SHAPES + X3D_RECT_DW_SHAPES + X3D_PORTRAIT_DW_SHAPES
    + X3D_TEST_DW_SHAPES
))


def _once(index, size):
    """Whether the values of ``index`` that fall in [0, size) take each of
    them exactly once."""
    index = np.asarray(index).ravel()
    return np.array_equal(np.bincount(index[index < size], minlength=size),
                          np.ones(size, int))


def _check_tiling(plan):
    """The block and thread coordinates of the kernels
    (dw3x3x3_stage.cuh::block_tile, then each kernel's thread coordinates)
    are independent digits of blockIdx.x and threadIdx.x, so the kernels
    cover each (b, t, h, w, channel group[, dt]) once exactly when each
    digit's range covers its axis once."""
    b, t, h, w, c = plan.shape
    assert plan.blocks == b * plan.nttiles * plan.nhtiles * plan.nchunks
    nq = plan.chunk // plan.cpt
    assert plan.threads == nq * plan.th * (3 if plan.wgrad else 1) * plan.nseg
    tt = np.arange(plan.tt)
    assert _once(np.arange(plan.nttiles)[:, None] * plan.tt + tt, t)
    assert _once(np.arange(plan.nhtiles)[:, None] * plan.th + np.arange(plan.th), h)
    sw = np.arange(plan.sw)
    assert _once(np.arange(plan.nseg)[:, None] * plan.sw + sw, w)
    assert _once(np.arange(plan.nchunks)[:, None] * nq + np.arange(nq), c // plan.cpt)
    assert (plan.nseg - 1) * plan.sw < w  # no W segment is empty


def _check_halo(plan):
    """A thread's reads lie in its block's staged rows, which reach one
    column beyond each output on both sides: K1 walks whole segments,
    staged columns ws .. ws+sw+1 (w = ws-1 .. ws+sw), the wgrad kernel
    ws .. we+1 of x and ws .. we-1 of g; every one within the row's pitch."""
    _, _, _, w, _ = plan.shape
    nv = 1 << plan.nv_log2
    starts = np.arange(plan.nseg) * plan.sw
    ends = np.minimum(starts + plan.sw, w)  # one past each segment's outputs
    last_read = ends + 1 if plan.wgrad else starts + plan.sw + 1
    assert (last_read.max() + 1) * nv <= plan.pitch
    if plan.wgrad:
        assert ends.max() * nv <= plan.gpitch


@pytest.mark.parametrize("kernel", ["forward", "wgrad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MAIN_SHAPES + list(ODD_SHAPES))
def test_launch_plan_covers_each_output_once(shape, dtype, kernel):
    elem = torch.tensor([], dtype=dtype).element_size()
    make = plan_forward if kernel == "forward" else plan_wgrad
    plan = make(shape, elem)
    _check_tiling(plan)
    _check_halo(plan)
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    # The shared bytes the C launchers demand for this plan.
    # Slots of whole 128-byte lines, then 64 bytes of mbarriers.
    lines = lambda units: -(-units // 8) * 8  # noqa: E731
    if kernel == "forward":  # the plane worked on and two in flight
        assert plan.threads <= 128 and plan.nv_log2 <= 1
        assert plan.smem_bytes == (3 * lines((plan.th + 2) * plan.pitch) + 4) * 16
    else:  # x ring of 4 planes, g ring of 2, reused by the block's final sum
        ring = (4 * lines((plan.th + 2) * plan.pitch)
                + 2 * lines(plan.th * plan.gpitch) + 4) * 16
        red = plan.th * plan.nseg * 27 * plan.chunk * 4
        assert plan.threads <= 512 and plan.smem_bytes == max(ring, red)
    # A tensor copy's box is a staged row: whole positions, at most 256.
    nv = 1 << plan.nv_log2
    for pitch in (plan.pitch, plan.gpitch) if kernel == "wgrad" else (plan.pitch,):
        assert pitch % nv == 0 and pitch // nv <= 256
    # A chunk is whole 16-byte units, and the pitch keeps a warp's phase on
    # distinct banks where a position is narrower than 128 bytes.
    assert shape[-1] % plan.chunk == 0 and plan.chunk * elem % 16 == 0
    if nv < 8:
        assert plan.pitch % 8 == nv and (kernel == "forward" or plan.gpitch % 8 == nv)
    if shape in MAIN_SHAPES:  # enough blocks to fill an H100
        assert plan.blocks >= H100_SMS


@pytest.mark.parametrize("shape, elem, kernel, tt", [
    ((8, 8, 7, 7, 768), 2, "forward", 4),    # 384 blocks of 56 threads: cut
    ((8, 8, 14, 14, 384), 2, "forward", 8),  # 384 blocks of 112: whole T
    ((8, 8, 14, 14, 384), 2, "wgrad", 4),    # 192 blocks: cut
    ((8, 8, 14, 14, 384), 4, "wgrad", 8),    # 384 blocks of 84: whole T
])
def test_launch_plan_cuts_t_only_for_small_grids(shape, elem, kernel, tt):
    """T is cut into ranges (each copies 2 more planes) only where the grid
    would hold fewer than two blocks or 6 warps for each SM of an H100."""
    plan = (plan_forward if kernel == "forward" else plan_wgrad)(shape, elem)
    assert plan.tt == tt


def test_launch_plan_refuses_rows_wider_than_a_tensor_copy():
    """A staged row is one tensor copy's box, at most 256 positions."""
    with pytest.raises(ValueError, match="no launch plan fits"):
        plan_forward((1, 1, 2, 400, 8), 2)


def test_launch_plan_refuses_channels_off_the_vector():
    with pytest.raises(ValueError, match="multiple of 8"):
        plan_forward((1, 1, 4, 4, 12), 2)


def test_library_path_hashes_headers(tmp_path, monkeypatch):
    """An edit to a shared header gives the kernels a new library name, so
    a stale build is never loaded."""
    from pmv_tpu_torch.ops import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setenv("PMV_TORCH_BUILD_DIR", str(tmp_path / "out"))
    headers = sorted(csrc.glob("*.cuh"))
    assert headers
    before = {s: build.library_path(s) for s in ("depthwise3x3x3", "depthwise3x3x3_wgrad")}
    headers[0].write_bytes(headers[0].read_bytes() + b"\n// edited\n")
    after = {s: build.library_path(s) for s in before}
    assert all(before[s] != after[s] for s in before)
    assert all(p.parent == tmp_path / "out" for p in after.values())
