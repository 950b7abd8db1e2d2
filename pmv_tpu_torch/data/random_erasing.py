"""Random erasing, on the device.

Counterpart of `pmv_tpu/data/random_erasing.py` (the timm port used by the
reference, applied per clip at `kinetics.py:505-515`): one box per clip,
shared by its frames. "pixel" mode fills the box with N(0, 1) noise,
"const" with zeros. As in the JAX package, the box is drawn once and clamped
to the frame, where the reference retries up to 10 times.

``sample_random_erasing`` draws the boxes (float32 arithmetic, as the JAX
package) from a CPU generator and the noise from a device generator;
``random_erasing`` applies them.
"""

import math
from dataclasses import dataclass

import torch


@dataclass
class ErasingDraws:
    """One box per clip: [B] tensors, and the fill (None in "const" mode)."""

    apply: torch.Tensor  # bool
    top: torch.Tensor  # int64
    left: torch.Tensor
    height: torch.Tensor
    width: torch.Tensor
    fill: torch.Tensor = None  # float32, the shape of the batch

    def rows(self, start, stop):
        """The draws of rows [start, stop)."""
        keep = slice(start, stop)
        return ErasingDraws(self.apply[keep], self.top[keep], self.left[keep],
                            self.height[keep], self.width[keep],
                            None if self.fill is None else self.fill[keep])


def sample_random_erasing(
    shape,
    generator,
    fill_generator=None,
    device=None,
    probability=0.25,
    min_area=0.02,
    max_area=1 / 3,
    min_aspect=0.3,
    max_aspect=None,
    mode="pixel",
):
    """ErasingDraws for a batch of ``shape`` [B, T, H, W, C]."""
    max_aspect = max_aspect or 1 / min_aspect
    b, _, h, w, _ = shape
    log_ratio = (math.log(min_aspect), math.log(max_aspect))

    def uniform(lo=0.0, hi=1.0):
        u = torch.rand(b, generator=generator)
        return lo + (hi - lo) * u if (lo, hi) != (0.0, 1.0) else u

    apply = uniform() < probability
    target_area = uniform(min_area, max_area) * (h * w)
    aspect = torch.exp(uniform(*log_ratio))
    eh = torch.round(torch.sqrt(target_area * aspect)).clamp(1, h).long()
    ew = torch.round(torch.sqrt(target_area / aspect)).clamp(1, w).long()
    top = (uniform() * (h - eh + 1)).long()
    left = (uniform() * (w - ew + 1)).long()
    fill = None
    if mode == "pixel":
        fill = torch.randn(tuple(shape), generator=fill_generator, device=device)
    return ErasingDraws(apply, top, left, eh, ew, fill)


def random_erasing(x, draws):
    """Erase one box per clip of x [B, T, H, W, C]."""
    _, _, h, w, _ = x.shape
    box = torch.stack(
        [draws.top, draws.height, draws.left, draws.width, draws.apply.long()]
    ).to(x.device, non_blocking=True)
    top, eh, left, ew, apply = box
    rows = torch.arange(h, device=x.device)[None, :]
    cols = torch.arange(w, device=x.device)[None, :]
    row_mask = (rows >= top[:, None]) & (rows < (top + eh)[:, None])  # [B, H]
    col_mask = (cols >= left[:, None]) & (cols < (left + ew)[:, None])  # [B, W]
    mask = row_mask[:, None, :, None, None] & col_mask[:, None, None, :, None]
    mask = mask & apply.bool()[:, None, None, None, None]
    if draws.fill is None:
        fill = torch.zeros_like(x)
    else:
        fill = draws.fill.to(device=x.device, dtype=x.dtype, non_blocking=True)
    return torch.where(mask, fill, x)
