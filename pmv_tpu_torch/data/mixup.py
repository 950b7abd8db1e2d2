"""MixUp / CutMix with label smoothing, on the device.

Counterpart of `pmv_tpu/data/mixup.py` (the reference's timm port,
`MViT/slowfast/datasets/mixup.py:22-194`): batch-level mixing against the
batch flipped on axis 0 (the global batch in a multi-process job), Beta-sampled lam, mixup <-> cutmix switching, and
one-hot soft targets with label smoothing. Inputs are channels-last video
batches [B, T, H, W, C].

``MixUp.sample`` draws one ``MixUpDraws`` per batch from a CPU
``torch.Generator``; ``MixUp.apply`` mixes. Scalars are float32, as the JAX
package computes them.
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


def _flip(t):
    return t.flip(0)


def mixup_target(labels, num_classes, lam, smoothing, flip=_flip):
    """Soft targets: lam * onehot(y) + (1-lam) * onehot(flip(y)), smoothed.
    ``flip`` gives each row's partner, the batch reversed on axis 0."""
    off_value = smoothing / num_classes
    on_value = 1.0 - smoothing + off_value
    lam = _f32(lam)
    y1 = F.one_hot(labels.long(), num_classes).float() * (on_value - off_value) + off_value
    y2 = F.one_hot(flip(labels).long(), num_classes).float() * (on_value - off_value) + off_value
    return lam * y1 + (1.0 - lam) * y2


def _rand_bbox(height, width, lam, cy, cx):
    """CutMix box of area about (1 - lam) centred at (cy, cx): returns the
    (y0, y1, x0, x1) bounds and the lam of the box actually cut."""
    ratio = torch.sqrt(1.0 - _f32(lam))
    cut_h = int(height * ratio)
    cut_w = int(width * ratio)
    yl = min(max(cy - cut_h // 2, 0), height)
    yh = min(max(cy + cut_h // 2, 0), height)
    xl = min(max(cx - cut_w // 2, 0), width)
    xh = min(max(cx + cut_w // 2, 0), width)
    box_area = (yh - yl) * (xh - xl)
    lam_corrected = 1.0 - _f32(box_area) / float(height * width)
    return (yl, yh, xl, xh), lam_corrected


def _uniform(generator):
    return float(torch.rand((), generator=generator))


def _sample_gamma(alpha, generator):
    """Gamma(alpha, 1) by Marsaglia and Tsang's method (with the
    U ** (1 / alpha) boost below alpha 1)."""
    if alpha < 1.0:
        u = _uniform(generator)
        return _sample_gamma(alpha + 1.0, generator) * u ** (1.0 / alpha)
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        z = float(torch.randn((), generator=generator))
        v = (1.0 + c * z) ** 3
        if v <= 0.0:
            continue
        u = _uniform(generator)
        if u > 0.0 and math.log(u) < 0.5 * z * z + d - d * v + d * math.log(v):
            return d * v


def sample_beta(a, b, generator):
    """Beta(a, b) as X / (X + Y) of two Gamma draws."""
    x = _sample_gamma(a, generator)
    y = _sample_gamma(b, generator)
    return x / (x + y)


@dataclass
class MixUpDraws:
    """The random parameters of one MixUp call."""

    apply: bool  # mix at all (else lam = 1)
    use_cutmix: bool
    lam_mix: torch.Tensor  # float32 scalars
    lam_cut: torch.Tensor
    cy: int  # CutMix box centre
    cx: int


class MixUp:
    """Batch-level MixUp/CutMix (`pmv_tpu/data/mixup.py::MixUp`)."""

    def __init__(
        self,
        mixup_alpha=1.0,
        cutmix_alpha=0.0,
        mix_prob=1.0,
        switch_prob=0.5,
        label_smoothing=0.1,
        num_classes=1000,
    ):
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.mix_prob = mix_prob
        self.switch_prob = switch_prob
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes

    def sample(self, height, width, generator):
        """Draw one MixUpDraws for an [B, T, height, width, C] batch."""
        apply = _uniform(generator) < self.mix_prob
        use_cutmix = self.cutmix_alpha > 0.0 and _uniform(generator) < self.switch_prob
        lam_mix = (
            sample_beta(self.mixup_alpha, self.mixup_alpha, generator)
            if self.mixup_alpha > 0.0 else 1.0
        )
        lam_cut = (
            sample_beta(self.cutmix_alpha, self.cutmix_alpha, generator)
            if self.cutmix_alpha > 0.0 else 1.0
        )
        cy = int(torch.randint(0, height, (), generator=generator))
        cx = int(torch.randint(0, width, (), generator=generator))
        return MixUpDraws(apply, use_cutmix, _f32(lam_mix), _f32(lam_cut), cy, cx)

    def apply(self, x, labels, draws, flip=_flip):
        """Returns (mixed x, soft targets [B, num_classes] float32).
        ``flip(t)`` gives the partner rows of ``t``'s rows: the batch
        reversed on axis 0, or on one rank of a multi-process job the rows
        that the global batch reversed puts there (``engine/steps.py``). It
        is called only when the batch mixes."""
        if not draws.apply:
            return x, mixup_target(labels, self.num_classes, 1.0, self.label_smoothing)
        x_flip = flip(x)
        if draws.use_cutmix:
            height, width = x.shape[-3], x.shape[-2]
            (yl, yh, xl, xh), lam = _rand_bbox(height, width, draws.lam_cut, draws.cy, draws.cx)
            x = x.clone()
            x[..., yl:yh, xl:xh, :] = x_flip[..., yl:yh, xl:xh, :]
        else:
            lam = draws.lam_mix
            x = x * lam + x_flip * (1.0 - lam)
        targets = mixup_target(labels, self.num_classes, lam, self.label_smoothing, flip)
        return x, targets
