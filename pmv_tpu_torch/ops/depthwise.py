"""Stride-1, SAME, 3x3x3 depthwise conv3d on channels-last tensors.

The port's counterpart of ``pmv_tpu/ops/depthwise_pallas.py``. MViT sends
its stride-1 3x3x3 pooling convs here (``models/attention.py``).

- ``depthwise3x3x3(x, w)``: the wrapper. A CUDA tensor launches the
  hand-written kernel ``csrc/depthwise3x3x3.cu`` (it replaces the TPU kernel
  ``depthwise3x3x3_fwd``, body ``_dw_fwd_kernel``); a CPU tensor takes the
  plain version. Nothing else falls back: a CUDA input the kernel does not
  take, a failed build or a refused launch raises. The forward pass only:
  on CUDA it raises when ``x`` or ``w`` requires grad.
- ``depthwise3x3x3_plain(x, w)``: pad, then 27 shifted multiply-adds in
  float32. The CPU path, and the reference the kernel is held against.

Bound on the card: bytes (read x and w once, write out once); see the
kernel source for its design.
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


def _library():
    lib = load_library("depthwise3x3x3")
    fn = lib.pmv_dw3x3x3_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return fn


def _check(x, w):
    if x.dim() != 5 or tuple(w.shape) != (3, 3, 3, x.shape[-1]):
        raise ValueError(
            f"depthwise3x3x3 takes x [B,T,H,W,C] and w [3,3,3,C], got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(
            f"depthwise3x3x3 takes float32 or bfloat16 x and w of one type, "
            f"got {x.dtype} and {w.dtype}"
        )
    if x.shape[-1] % 8:
        raise ValueError(f"C must be a multiple of 8, got {x.shape[-1]}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if x.requires_grad or w.requires_grad:
        raise RuntimeError(
            "the depthwise3x3x3 CUDA kernel is forward-only; run it under "
            "torch.no_grad() or torch.inference_mode()"
        )


def depthwise3x3x3(x, w):
    """x [B, T, H, W, C], w [3, 3, 3, C] -> [B, T, H, W, C] in x.dtype.

    Counts its kernel launches in ``depthwise3x3x3.launches``."""
    if x.device.type == "cpu":
        return depthwise3x3x3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise3x3x3 runs on cpu or cuda, not {x.device}")
    _check(x, w)
    fn = _library()
    out = torch.empty_like(x)
    b, t, h, wd, c = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 b, t, h, wd, c, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"depthwise3x3x3 kernel launch failed: cudaError {err}"
        )
    depthwise3x3x3.launches += 1
    return out


depthwise3x3x3.launches = 0
