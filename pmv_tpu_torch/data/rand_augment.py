"""RandAugment, on the device.

Counterpart of `pmv_tpu/data/rand_augment.py` (the timm RandAugment used by
the reference through PIL per frame, `kinetics.py:429-440`). Images are
float32 in [0, 255], channels-last [N, H, W, C]; every frame of a group
(one clip under per-clip chains) gets the same ops and magnitudes.

The op functions compute what the JAX package computes, so the port is held
against it on the same parameters:
- geometric ops resample bilinearly through a banded interpolation matrix,
  one axis at a time, and blend toward the fill value 128 by the weight
  missing where a sample falls outside the image (the "deficit"); rotate is
  the Paeth three-shear chain (x, y, x). ``F.grid_sample`` computes
  something else (one 2-D pass, other edge handling).
- ``_contrast`` takes its mean over the whole group passed in (the clip),
  ``_autocontrast`` and ``_equalize`` work per frame and channel;
  ``_equalize`` is PIL's integer LUT, exact.
- Level arithmetic is float32, as traced in JAX.

``RandAugment.sample`` draws per (group, layer) an op index, a magnitude and
a sign from a CPU generator; ``RandAugment.apply_batch`` applies them.
"""

import math
import re
from dataclasses import dataclass

import torch
import torch.nn.functional as F

_LEVEL_DENOM = 10.0
_FILL = 128.0


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


# --------------------------------------------------------------- affine warp
def _resample_x(img, src_x):
    """1-D bilinear resample along W: out[t,h,x,c] = img[t,h,src_x[h,x],c].
    src_x: [H, W_out] source positions (fractional, maybe out of range)."""
    _, _, w, _ = img.shape
    u = torch.arange(w, dtype=torch.float32, device=img.device)
    wmat = (1.0 - (src_x[:, None, :] - u[None, :, None]).abs()).clamp_min(0.0)
    deficit = 1.0 - wmat.sum(dim=1)  # [H, W_out]
    out = torch.einsum("thuc,hux->thxc", img, wmat)
    return out + deficit[None, :, :, None] * _FILL


def _resample_y(img, src_y):
    """1-D bilinear resample along H: out[t,y,x,c] = img[t,src_y[y,x],x,c].
    src_y: [H_out, W] source positions."""
    _, h, _, _ = img.shape
    v = torch.arange(h, dtype=torch.float32, device=img.device)
    # wmat[x, v, y] = bilinear weight of input row v for output (y, x)
    wmat = (1.0 - (src_y.t()[:, None, :] - v[None, :, None]).abs()).clamp_min(0.0)
    deficit = 1.0 - wmat.sum(dim=1)  # [W, H_out]
    out = torch.einsum("tvxc,xvy->tyxc", img, wmat)
    return out + deficit.t()[None, :, :, None] * _FILL


def _resample_x_const(img, src_x_row):
    """_resample_x when every row shares the source positions [W_out]."""
    _, _, w, _ = img.shape
    u = torch.arange(w, dtype=torch.float32, device=img.device)
    wmat = (1.0 - (src_x_row[None, :] - u[:, None]).abs()).clamp_min(0.0)
    deficit = 1.0 - wmat.sum(dim=0)  # [W_out]
    out = torch.einsum("thuc,ux->thxc", img, wmat)
    return out + deficit[None, None, :, None] * _FILL


def _resample_y_const(img, src_y_col):
    """_resample_y when every column shares the source positions [H_out]."""
    _, h, _, _ = img.shape
    v = torch.arange(h, dtype=torch.float32, device=img.device)
    wmat = (1.0 - (src_y_col[None, :] - v[:, None]).abs()).clamp_min(0.0)
    deficit = 1.0 - wmat.sum(dim=0)  # [H_out]
    out = torch.einsum("tvxc,vy->tyxc", img, wmat)
    return out + deficit[None, :, None, None] * _FILL


def _grid(h, w, device):
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    return torch.meshgrid(xs, ys, indexing="xy")  # X, Y each [H, W]


def _rotate(img, degrees):
    """Rotation about the centre as a Paeth three-shear (x, y, x) chain:
    alpha = tan(theta / 2) for both x-shears, beta = -sin(theta)."""
    _, h, w, _ = img.shape
    angle = -_f32(degrees) * math.pi / 180.0
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    alpha = torch.tan(angle / 2.0)
    beta = -torch.sin(angle)
    X, Y = _grid(h, w, img.device)
    src_x = X + alpha * (Y - cy)
    src_y = Y + beta * (X - cx)
    img = _resample_x(img, src_x)
    img = _resample_y(img, src_y)
    return _resample_x(img, src_x)


def _shear_x(img, factor):
    _, h, w, _ = img.shape
    X, Y = _grid(h, w, img.device)
    return _resample_x(img, X + factor * Y)


def _shear_y(img, factor):
    _, h, w, _ = img.shape
    X, Y = _grid(h, w, img.device)
    return _resample_y(img, Y + factor * X)


def _translate_x(img, pixels):
    xs = torch.arange(img.shape[2], dtype=torch.float32, device=img.device)
    return _resample_x_const(img, xs + pixels)


def _translate_y(img, pixels):
    ys = torch.arange(img.shape[1], dtype=torch.float32, device=img.device)
    return _resample_y_const(img, ys + pixels)


# --------------------------------------------------------------- color ops
def _blend(img, degenerate, factor):
    return (degenerate + factor * (img - degenerate)).clamp(0.0, 255.0)


def _grayscale(img):
    lum = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return lum[..., None].expand(img.shape)


def _color(img, factor):
    return _blend(img, torch.round(_grayscale(img)), factor)


def _contrast(img, factor):
    mean = torch.round(_grayscale(img)).mean()
    return _blend(img, mean, factor)


def _brightness(img, factor):
    return _blend(img, 0.0, factor)


def _sharpness(img, factor):
    t, h, w, c = img.shape
    kernel = torch.tensor(
        [[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]], device=img.device
    ) / 13.0
    x = img.permute(0, 3, 1, 2).reshape(t * c, 1, h, w)
    smoothed = F.conv2d(x, kernel[None, None], padding=1)
    smoothed = smoothed.reshape(t, c, h, w).permute(0, 2, 3, 1)
    # PIL keeps the 1-pixel border unchanged.
    border = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    border[1:-1, 1:-1] = True
    degenerate = torch.where(border[None, :, :, None], smoothed, img)
    return _blend(img, degenerate, factor)


def _invert(img, _):
    return 255.0 - img


def _autocontrast(img, _):
    """Per-frame, per-channel min/max rescale (PIL autocontrast, cutoff 0)."""
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    spread = hi > lo
    scale = torch.where(spread, 255.0 / (hi - lo), torch.ones_like(hi))
    offset = torch.where(spread, -lo * scale, torch.zeros_like(lo))
    return (img * scale + offset).clamp(0.0, 255.0)


def _equalize(img, _):
    """PIL ImageOps.equalize's integer LUT, per frame and channel."""
    t, h, w, c = img.shape
    flat = torch.round(img.permute(0, 3, 1, 2)).reshape(t * c, h * w).long()
    rows = torch.arange(t * c, device=img.device)[:, None] * 256
    hist = torch.bincount((rows + flat).flatten(), minlength=t * c * 256)
    hist = hist.reshape(t * c, 256)
    nonzero = (hist > 0).long()
    last_idx = 255 - nonzero.flip(-1).argmax(dim=-1)
    last_count = hist.gather(-1, last_idx[:, None])[:, 0]
    step = (hist.sum(dim=-1) - last_count) // 255
    shifted = torch.cumsum(hist, dim=-1) - hist
    lut = (step[:, None] // 2 + shifted) // step.clamp_min(1)[:, None]
    lut = lut.clamp(0, 255)
    identity = torch.arange(256, device=img.device).expand(t * c, 256)
    lut = torch.where(step[:, None] == 0, identity, lut)
    out = lut.gather(-1, flat).to(img.dtype)
    return out.reshape(t, c, h, w).permute(0, 2, 3, 1)


def _posterize(img, bits):
    """Keep the ``bits`` high bits of each rounded value."""
    shift = 8 - min(max(int(bits), 0), 8)
    vals = torch.round(img).int()
    return ((vals >> shift) << shift).to(img.dtype)


def _solarize(img, thresh):
    return torch.where(img >= thresh, 255.0 - img, img)


def _solarize_add(img, add):
    return torch.where(img < 128.0, (img + add).clamp(0.0, 255.0), img)


# ------------------------------------------------------- magnitude -> arg
def _make_ops(hparams):
    """(name, fn, level_fn) table: timm's `rand-...-inc1` increasing set.
    A level function maps (m, negate) to the op's argument, in float32."""
    translate_pct = hparams.get("translate_pct", 0.45)

    def signed(v, negate):
        return -v if negate else v

    def lvl_rotate(m, negate):
        return signed(m / _LEVEL_DENOM * 30.0, negate)

    def lvl_shear(m, negate):
        return signed(m / _LEVEL_DENOM * 0.3, negate)

    def lvl_enhance_inc(m, negate):
        return 1.0 + signed(m / _LEVEL_DENOM * 0.9, negate)

    def lvl_posterize_inc(m, negate):
        return 4 - int(torch.round(m / _LEVEL_DENOM * 4))

    def lvl_solarize_inc(m, negate):
        return 256.0 - torch.round(m / _LEVEL_DENOM * 256)

    def lvl_solarize_add(m, negate):
        return torch.round(m / _LEVEL_DENOM * 110)

    def lvl_translate(m, negate):
        return signed(m / _LEVEL_DENOM * translate_pct, negate)

    def lvl_none(m, negate):
        return _f32(0.0)

    return [
        ("AutoContrast", _autocontrast, lvl_none),
        ("Equalize", _equalize, lvl_none),
        ("Invert", _invert, lvl_none),
        ("Rotate", _rotate, lvl_rotate),
        ("Posterize", _posterize, lvl_posterize_inc),
        ("Solarize", _solarize, lvl_solarize_inc),
        ("SolarizeAdd", _solarize_add, lvl_solarize_add),
        ("Color", _color, lvl_enhance_inc),
        ("Contrast", _contrast, lvl_enhance_inc),
        ("Brightness", _brightness, lvl_enhance_inc),
        ("Sharpness", _sharpness, lvl_enhance_inc),
        ("ShearX", _shear_x, lvl_shear),
        ("ShearY", _shear_y, lvl_shear),
        ("TranslateX", _translate_x, lvl_translate),
        ("TranslateY", _translate_y, lvl_translate),
    ]


def parse_rand_augment_config(config_str):
    """Parse 'rand-m7-n4-mstd0.5-inc1' (timm syntax) -> dict."""
    parts = config_str.split("-")
    if parts[0] != "rand":
        raise ValueError(f"not a rand-augment config: {config_str}")
    out = {"magnitude": 9, "num_layers": 2, "magnitude_std": 0.0, "increasing": False}
    for p in parts[1:]:
        m = re.match(r"([a-z]+)([0-9.]+)", p)
        if m is None:
            continue
        key, val = m.group(1), float(m.group(2))
        if key == "m":
            out["magnitude"] = val
        elif key == "n":
            out["num_layers"] = int(val)
        elif key == "mstd":
            out["magnitude_std"] = val
        elif key == "inc":
            out["increasing"] = bool(val)
        elif key == "p":
            out["prob"] = val
    return out


@dataclass
class RandAugmentDraws:
    """Per (group, layer): op index, magnitude (clipped to [0, 10]) and
    whether the level is negated. [G, num_layers] CPU tensors."""

    op_idx: torch.Tensor  # int64
    magnitude: torch.Tensor  # float32
    negate: torch.Tensor  # bool

    def rows(self, start, stop, batch):
        """The draws of rows [start, stop) of a ``batch``-row batch drawn
        with these: the groups that hold them. A group's ops see all its
        rows at once (``_contrast`` takes their mean), so the rows must be
        whole groups."""
        chunk = batch // self.op_idx.shape[0]
        if start % chunk or stop % chunk:
            raise ValueError(
                f"rows [{start}, {stop}) cut a RandAugment group of {chunk} rows: "
                "set AUG.RA_GROUPS so that each process's rows are whole groups"
            )
        keep = slice(start // chunk, stop // chunk)
        return RandAugmentDraws(self.op_idx[keep], self.magnitude[keep], self.negate[keep])


class RandAugment:
    """RandAugment: ``num_layers`` ops per group, applied in sequence."""

    def __init__(self, config_str="rand-m9-n2-mstd0.5", hparams=None):
        cfg = parse_rand_augment_config(config_str)
        self.magnitude = cfg["magnitude"]
        self.num_layers = cfg["num_layers"]
        self.magnitude_std = cfg["magnitude_std"]
        self.ops = _make_ops(hparams or {})

    def sample(self, groups, generator):
        """RandAugmentDraws for ``groups`` independent chains."""
        shape = (groups, self.num_layers)
        op_idx = torch.randint(0, len(self.ops), shape, generator=generator)
        m = torch.full(shape, float(self.magnitude))
        if self.magnitude_std > 0:
            m = m + self.magnitude_std * torch.randn(shape, generator=generator)
        m = m.clamp(0.0, _LEVEL_DENOM)
        negate = torch.rand(shape, generator=generator) < 0.5
        return RandAugmentDraws(op_idx, m, negate)

    def apply_op(self, img, op_idx, magnitude, negate):
        """One op on img [N, H, W, C] at magnitude ``magnitude`` (a float32
        scalar tensor)."""
        _, fn, lvl_fn = self.ops[int(op_idx)]
        return fn(img, lvl_fn(_f32(magnitude), bool(negate))).to(img.dtype)

    def apply_batch(self, x, draws):
        """x [B, T, H, W, C]: the batch splits into G = len(draws.op_idx)
        equal groups of clips, each through its own chain (G = B: per-clip
        chains, the reference's sampling)."""
        b, t, h, w, c = x.shape
        groups = draws.op_idx.shape[0]
        if b % groups:
            raise ValueError(f"{groups} RandAugment groups do not divide batch {b}")
        chunk = b // groups
        outs = []
        for g in range(groups):
            img = x[g * chunk:(g + 1) * chunk].reshape(chunk * t, h, w, c)
            for layer in range(self.num_layers):
                img = self.apply_op(
                    img, draws.op_idx[g, layer], draws.magnitude[g, layer],
                    draws.negate[g, layer],
                )
            outs.append(img.reshape(chunk, t, h, w, c))
        return torch.cat(outs, dim=0)


def num_groups(batch, groups):
    """The JAX package's group count: ``groups`` clamped to the batch, then
    lowered until it divides the batch (AUG.RA_GROUPS <= 0: one per clip)."""
    groups = max(1, min(groups if groups > 0 else batch, batch))
    while batch % groups:
        groups -= 1
    return groups
