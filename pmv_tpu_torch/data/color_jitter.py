"""SSL colour augmentation on the device (contrastive pre-training recipes).

Counterpart of `pmv_tpu/data/color_jitter.py` (the reference's
`transform.py:1263-1390`: ``color_jitter_video_ssl``, ``temporal_difference``,
``augment_raw_frames``, ``GaussianBlur``). x is float [B, T, H, W, C] in
[0, 255]; every ``adjust_*`` is torchvision's on that domain (blend, then
clamp). As in the JAX package, the blur is a true per-frame 2-D gaussian,
where the reference PIL-blurs the clip flattened to (C, T * H, W), across
frame boundaries.

Each op is split into "sample" (the draws, from a CPU generator) and
"apply" (the math on given draws), as RandAugment and erasing are, so that
the CPU tests can feed the port the JAX package's draws:

- ``ColorJitterDraws``: per clip the brightness, contrast and saturation
  factors and the hue delta, and one order of the four ops for the whole
  batch (one of the 24 permutations, the JAX package's ``lax.switch`` on a
  scalar, `color_jitter.py:107-128`);
- ``SSLColorDraws``: those, the grayscale coin, and for the moco-v2
  recipe the jitter coin (p 0.8), the blur coin (p 0.5) and the blur sigma;
- ``sample_time_difference``: the per-clip coin of the time difference.

- ``AVAColorDraws``: the AVA colour augmentation's (DETECTION.ENABLE with
  AVA.TRAIN_USE_COLOR_AUGMENTATION, `pmv_tpu/engine/steps.py:63-87`): the
  jitter's at hue 0, unless AVA.TRAIN_PCA_JITTER_ONLY, and the [B, 3]
  alphas of ``lighting_jitter`` (alphastd 0.1).
"""

import itertools
from dataclasses import dataclass

import torch

_GRAY_W = (0.299, 0.587, 0.114)  # ITU-R 601, torchvision rgb_to_grayscale
# The 24 orders of (brightness, contrast, saturation, hue), in the JAX
# package's order (lexicographic).
ORDERS = list(itertools.permutations(range(4)))


def rgb_to_grayscale(x):
    """[..., 3] -> [..., 1] luminance (torchvision weights)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return (_GRAY_W[0] * r + _GRAY_W[1] * g + _GRAY_W[2] * b)[..., None]


def _per_clip(v, x):
    """A [B] draw broadcast over x's other axes, on x's device and dtype."""
    return v.to(device=x.device, dtype=x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))


def _clip_mask(take, x):
    """A [B] bool draw broadcast over x's other axes, on x's device."""
    return take.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))


def _blend(img1, img2, factor):
    return torch.clamp(factor * img1 + (1.0 - factor) * img2, 0.0, 255.0)


def adjust_brightness(x, factor):
    return _blend(x, torch.zeros_like(x), factor)


def adjust_contrast(x, factor):
    """Blend with the mean of the clip's grayscale image (over T, H, W)."""
    mean = rgb_to_grayscale(x).mean(dim=tuple(range(1, x.dim())), keepdim=True)
    return _blend(x, mean, factor)


def adjust_saturation(x, factor):
    return _blend(x, rgb_to_grayscale(x), factor)


def adjust_hue(x, delta):
    """Shift the hue by ``delta`` (a fraction of a turn, [B, 1, 1, 1] or a
    number) through HSV, as torchvision does. ``%`` is ``torch.remainder``
    (floor semantics, as ``jnp.remainder``), not ``fmod``."""
    x01 = x / 255.0
    r, g, b = x01[..., 0], x01[..., 1], x01[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    c = maxc - minc
    s = torch.where(v > 0, c / torch.clamp(v, min=1e-12), 0.0)
    safe_c = torch.clamp(c, min=1e-12)
    rc = (maxc - r) / safe_c
    gc = (maxc - g) / safe_c
    bc = (maxc - b) / safe_c
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(c > 0, h, 0.0)

    h = torch.remainder(h + delta, 1.0)

    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.long(), 6)[..., None]
    r2 = torch.stack([v, q, p, p, t, v], dim=-1).gather(-1, i)
    g2 = torch.stack([t, v, v, q, p, p], dim=-1).gather(-1, i)
    b2 = torch.stack([p, p, t, v, v, q], dim=-1).gather(-1, i)
    return torch.cat([r2, g2, b2], dim=-1) * 255.0


@dataclass
class ColorJitterDraws:
    """torchvision ColorJitter's draws: [B] factors and hue deltas, and one
    index into ``ORDERS`` for the batch."""

    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    order: int

    def rows(self, start, stop):
        keep = slice(start, stop)
        return ColorJitterDraws(self.brightness[keep], self.contrast[keep],
                                self.saturation[keep], self.hue[keep], self.order)


def _uniform(b, generator, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(b, generator=generator)


def sample_color_jitter(b, generator, brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1):
    """The ColorJitterDraws of a batch of ``b`` clips."""
    return ColorJitterDraws(
        _uniform(b, generator, max(0.0, 1 - brightness), 1 + brightness),
        _uniform(b, generator, max(0.0, 1 - contrast), 1 + contrast),
        _uniform(b, generator, max(0.0, 1 - saturation), 1 + saturation),
        _uniform(b, generator, -hue, hue),
        int(torch.randint(len(ORDERS), (), generator=generator)),
    )


def color_jitter(x, draws):
    """torchvision ColorJitter on x [B, T, H, W, C] with per-clip factors,
    the four ops in the batch's order (`color_jitter.py:88-128`)."""
    ops = (
        lambda y: adjust_brightness(y, _per_clip(draws.brightness, y)),
        lambda y: adjust_contrast(y, _per_clip(draws.contrast, y)),
        lambda y: adjust_saturation(y, _per_clip(draws.saturation, y)),
        lambda y: adjust_hue(y, _per_clip(draws.hue, y[..., 0])),
    )
    for idx in ORDERS[draws.order]:
        x = ops[idx](x)
    return x


def random_grayscale(x, take):
    """Per-clip RandomGrayscale: the clips where ``take`` ([B] bool) is set."""
    gray = rgb_to_grayscale(x).expand(x.shape)
    return torch.where(_clip_mask(take, x), gray, x)


def gaussian_blur(x, sigma, radius=5):
    """Separable 2-D gaussian blur of each frame, over H then W, with edge
    padding and a per-clip ``sigma`` ([B]); taps summed in the JAX
    package's order (`color_jitter.py:139-157`)."""
    offs = torch.arange(-radius, radius + 1, dtype=x.dtype, device=x.device)
    sigma = sigma.to(device=x.device, dtype=x.dtype)
    k1 = torch.exp(-(offs[None, :] ** 2) / (2.0 * sigma[:, None] ** 2))
    k1 = k1 / k1.sum(dim=1, keepdim=True)  # [B, 2 radius + 1]

    def blur_axis(y, axis):
        n = y.shape[axis]
        edge = torch.arange(-radius, n + radius, device=y.device).clamp(0, n - 1)
        yp = y.index_select(axis, edge)
        acc = torch.zeros_like(y)
        for i in range(2 * radius + 1):
            acc = acc + yp.narrow(axis, i, n) * _per_clip(k1[:, i], y)
        return acc

    return blur_axis(blur_axis(x, 2), 3)


@dataclass
class SSLColorDraws:
    """``ssl_color_jitter``'s draws: the jitter's, the [B] grayscale coin,
    and for the moco-v2 recipe the [B] jitter and blur coins and the [B]
    blur sigma (None otherwise)."""

    jitter: ColorJitterDraws
    gray: torch.Tensor
    apply_jitter: torch.Tensor = None
    apply_blur: torch.Tensor = None
    sigma: torch.Tensor = None

    def rows(self, start, stop):
        keep = slice(start, stop)

        def cut(t):
            return None if t is None else t[keep]

        return SSLColorDraws(self.jitter.rows(start, stop), self.gray[keep],
                             cut(self.apply_jitter), cut(self.apply_blur), cut(self.sigma))


def sample_ssl_color_jitter(b, generator, bri_con_sat=(0.4, 0.4, 0.4), hue=0.1,
                            p_convert_gray=0.0, moco_v2_aug=False, blur_sigma=(0.1, 2.0)):
    """The SSLColorDraws of a batch of ``b`` clips."""
    jitter = sample_color_jitter(b, generator, *bri_con_sat, hue)
    gray = torch.rand(b, generator=generator) < p_convert_gray
    if not moco_v2_aug:
        return SSLColorDraws(jitter, gray)
    return SSLColorDraws(
        jitter, gray,
        apply_jitter=torch.rand(b, generator=generator) < 0.8,
        apply_blur=torch.rand(b, generator=generator) < 0.5,
        sigma=_uniform(b, generator, *blur_sigma),
    )


def ssl_color_jitter(x, draws, moco_v2_aug=False):
    """``color_jitter_video_ssl`` (`transform.py:1289-1338`) on the device.

    moco_v2: RandomApply(jitter, .8) -> RandomGrayscale -> RandomApply(blur, .5)
    else:    RandomGrayscale -> jitter
    """
    if moco_v2_aug:
        x = torch.where(_clip_mask(draws.apply_jitter, x),
                        color_jitter(x, draws.jitter), x)
        x = random_grayscale(x, draws.gray)
        return torch.where(_clip_mask(draws.apply_blur, x),
                           gaussian_blur(x, draws.sigma), x)
    return color_jitter(random_grayscale(x, draws.gray), draws.jitter)


def lighting_jitter(x, alpha, eigval, eigvec, scale=255.0):
    """AlexNet-style PCA lighting jitter (`transform.py:583-620`): per clip
    the channel offset rgb_c = sum_j eigvec[c, j] alpha_j eigval_j, times
    ``scale`` (the reference's [0, 1] domain on the [0, 255] one)."""
    ev = torch.as_tensor(eigval, dtype=torch.float32)
    evec = torch.as_tensor(eigvec, dtype=torch.float32)
    rgb = torch.einsum("cj,bj->bc", evec, alpha.float() * ev[None, :]) * scale
    return x + rgb.to(device=x.device, dtype=x.dtype)[:, None, None, None, :]


@dataclass
class AVAColorDraws:
    """``ava_color``'s draws: the jitter's (None with PCA jitter only) and
    the lighting jitter's [B, 3] alphas, already times alphastd."""

    jitter: ColorJitterDraws
    alpha: torch.Tensor

    def rows(self, start, stop):
        jitter = None if self.jitter is None else self.jitter.rows(start, stop)
        return AVAColorDraws(jitter, self.alpha[start:stop])


def sample_ava_color(b, generator, pca_only, alphastd=0.1):
    """The AVAColorDraws of a batch of ``b`` clips."""
    jitter = None if pca_only else sample_color_jitter(b, generator, 0.4, 0.4, 0.4, hue=0.0)
    return AVAColorDraws(jitter, alphastd * torch.randn((b, 3), generator=generator))


def ava_color(x, draws, eigval, eigvec):
    """The AVA colour augmentation on the device: ColorJitter(0.4, 0.4, 0.4,
    hue 0) where drawn, then the PCA lighting jitter."""
    if draws.jitter is not None:
        x = color_jitter(x, draws.jitter)
    return lighting_jitter(x, draws.alpha, eigval, eigvec)


def temporal_difference(x, use_grayscale=True, absolute=False):
    """Frame differencing (`transform.py:1263-1287`): out[t] = x[t] - x[t+1];
    the last frame repeats the difference before it."""
    if use_grayscale:
        x = rgb_to_grayscale(x).expand(x.shape)
    if x.shape[1] <= 1:
        return torch.zeros_like(x)
    dt = x[:, :-1] - x[:, 1:]
    if absolute:
        dt = dt.abs()
    return torch.cat([dt, dt[:, -1:]], dim=1)


def sample_time_difference(b, generator, prob):
    """The [B] coins of ``augment_time_difference``."""
    return torch.rand(b, generator=generator) < prob


def augment_time_difference(x, take):
    """``augment_raw_frames``'s time-difference branch: the clips where
    ``take`` ([B] bool) is set become (gray temporal difference + 255) / 2."""
    td = (temporal_difference(x, use_grayscale=True) + 255.0) / 2.0
    return torch.where(_clip_mask(take, x), td, x)
