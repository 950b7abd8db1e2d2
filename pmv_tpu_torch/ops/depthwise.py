"""Stride-1, SAME, 3x3x3 depthwise conv3d on channels-last tensors, with its
gradient.

The port's counterpart of ``pmv_tpu/ops/depthwise_pallas.py``. MViT sends
its stride-1 3x3x3 pooling convs here (``models/attention.py``).

- ``depthwise3x3x3(x, w)``: differentiable, a ``torch.autograd.Function``
  as the JAX package's ``custom_vjp``. The forward is the kernel K1,
  ``csrc/depthwise3x3x3.cu`` (it replaces the TPU kernel
  ``depthwise3x3x3_fwd``, body ``_dw_fwd_kernel``). The backward computes
  dx as K1 on the cotangent with the weights flipped on all three axes, and
  dw with the kernel ``csrc/depthwise3x3x3_wgrad.cu`` (``_bwd``'s 27
  shifted reductions), accumulated in float32 and cast to ``w.dtype``.
- ``depthwise3x3x3_wgrad(x, g)``: the weight-gradient kernel's wrapper.
- ``depthwise3x3x3_plain`` and ``depthwise3x3x3_wgrad_plain``: pad, then 27
  shifted products in float32. The CPU path, and the references the
  kernels are held against.

A CUDA tensor launches the kernels; a CPU tensor takes the plain versions.
Nothing else falls back: a CUDA input the kernels do not take, a failed
build or a refused launch raises. Each wrapper counts its launches in
``.launches``.

Bound on the card: bytes, for both kernels; see the kernel sources.
"""

import ctypes

import torch
import torch.nn.functional as F

from pmv_tpu_torch.ops.build import load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def depthwise3x3x3_plain(x, w):
    """x [B, T, H, W, C], w [3, 3, 3, C] -> [B, T, H, W, C] in x.dtype."""
    _, t, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dt in range(3):
        for dh in range(3):
            for dw in range(3):
                acc += xp[:, dt:dt + t, dh:dh + h, dw:dw + wd] * wf[dt, dh, dw]
    return acc.to(x.dtype)


def depthwise3x3x3_wgrad_plain(x, g):
    """x, g [B, T, H, W, C] -> dw [3, 3, 3, C] in x.dtype:
    dw[dt, dh, dw, c] = sum over (b, t, h, w) of xpad[.., t+dt, h+dh, w+dw, c]
    * g[b, t, h, w, c], in float32."""
    _, t, h, wd, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    gf = g.float()
    taps = [
        (xp[:, dt:dt + t, dh:dh + h, dw:dw + wd] * gf).sum(dim=(0, 1, 2, 3))
        for dt in range(3) for dh in range(3) for dw in range(3)
    ]
    return torch.stack(taps).reshape(3, 3, 3, c).to(x.dtype)


def _function(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _check(op, x, other, other_shape):
    """Device, type, shape, contiguity and alignment of a kernel's inputs."""
    if x.device.type != "cuda":
        raise ValueError(f"{op} runs on cpu or cuda, not {x.device}")
    if x.dim() != 5 or tuple(other.shape) != tuple(other_shape):
        raise ValueError(
            f"{op} takes [B,T,H,W,C] and {list(other_shape)}, got "
            f"{tuple(x.shape)} and {tuple(other.shape)}"
        )
    if x.dtype not in _DTYPES or other.dtype != x.dtype:
        raise TypeError(
            f"{op} takes float32 or bfloat16 inputs of one type, got "
            f"{x.dtype} and {other.dtype}"
        )
    if x.shape[-1] % 8:
        raise ValueError(f"C must be a multiple of 8, got {x.shape[-1]}")
    if other.device != x.device:
        raise ValueError(f"inputs on {x.device} and {other.device}")
    for t in (x, other):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{op} takes contiguous, 16-byte aligned inputs")


def _raise_on(err, op):
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: cudaError {err}")


def _forward(x, w):
    """K1: one launch on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return depthwise3x3x3_plain(x, w)
    _check("depthwise3x3x3", x, w, (3, 3, 3, x.shape[-1]))
    fn = _function(load_library("depthwise3x3x3"), "pmv_dw3x3x3_fwd", 3, 6)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), *x.shape,
                 _DTYPES[x.dtype], stream)
    _raise_on(err, "depthwise3x3x3")
    depthwise3x3x3.launches += 1
    return out


def _wgrad_blocks(shape, num_sms):
    """Row blocks (blockIdx.x) of the wgrad kernel: about four blocks of 128
    threads per SM over all 64-channel chunks, and at least 4 (b, t, h)
    rows, one per row lane, in each."""
    b, t, h, _, c = shape
    chunks = -(-(c // 2) // 32)
    return max(1, min(-(-4 * num_sms // chunks), -(-(b * t * h) // 4)))


def depthwise3x3x3_wgrad(x, g):
    """x, g [B, T, H, W, C] -> dw [3, 3, 3, C] in x.dtype, the weight
    gradient of ``depthwise3x3x3`` (float32 accumulation). Two launches on
    CUDA (partial sums, then their fixed-order sum), counted as one in
    ``depthwise3x3x3_wgrad.launches``; the plain version on the CPU."""
    if x.device.type == "cpu":
        return depthwise3x3x3_wgrad_plain(x, g)
    _check("depthwise3x3x3_wgrad", x, g, x.shape)
    fn = _function(load_library("depthwise3x3x3_wgrad"), "pmv_dw3x3x3_wgrad", 4, 7)
    c = x.shape[-1]
    nblocks = _wgrad_blocks(
        x.shape, torch.cuda.get_device_properties(x.device).multi_processor_count
    )
    partial = torch.empty((nblocks, 27, c), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, 3, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                 *x.shape, nblocks, _DTYPES[x.dtype], stream)
    _raise_on(err, "depthwise3x3x3_wgrad")
    depthwise3x3x3_wgrad.launches += 1
    return dw


depthwise3x3x3_wgrad.launches = 0


def _aligned(t):
    """``t`` contiguous and 16-byte aligned, copied only when it is not."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class Depthwise3x3x3(torch.autograd.Function):
    """The JAX package's ``custom_vjp`` ``depthwise3x3x3`` (`:124-155`)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = _aligned(g)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # A stride-1 SAME conv is its own transpose up to a kernel flip.
            w_flip = w.flip(0, 1, 2).contiguous()
            dx = _forward(g, w_flip).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = depthwise3x3x3_wgrad(x, g).to(w.dtype)
        return dx, dw


def depthwise3x3x3(x, w):
    """x [B, T, H, W, C], w [3, 3, 3, C] -> [B, T, H, W, C] in x.dtype,
    differentiable in x and w.

    Counts the launches of K1, forward and dx alike, in
    ``depthwise3x3x3.launches``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"depthwise3x3x3 runs on cpu or cuda, not {x.device}")
    return Depthwise3x3x3.apply(x, w)


depthwise3x3x3.launches = 0
