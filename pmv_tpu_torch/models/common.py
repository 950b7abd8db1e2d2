"""Shared model building blocks on channels-last [B, T, H, W, C] tensors.

Counterparts of `pmv_tpu/models/common.py`. Parameters stay float32; the
layers compute in the dtype of their input (bfloat16 activations on the
card by default, float32 in the tests), as the JAX package's ``dtype=``
modules do.
"""

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """nn.Linear that computes in its input's dtype (weights cast per call)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics, returning its input's dtype
    (flax LayerNorm's float32 reductions; eps 1e-6 as the reference)."""

    def __init__(self, dim, eps=1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        y = F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )
        return y.to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> GELU -> drop -> fc2 -> drop.

    The GELU is the tanh approximation, as in the JAX package (flax's
    ``nn.gelu`` default); the reference uses the exact erf form. ROADMAP.md
    records the difference under Faults.
    """

    def __init__(self, in_features, hidden_features, out_features, drop_rate=0.0):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features)
        self.drop = nn.Dropout(drop_rate) if drop_rate > 0 else nn.Identity()

    def forward(self, x):
        x = F.gelu(self.fc1(x), approximate="tanh")
        return self.drop(self.fc2(self.drop(x)))


class DropPath(nn.Module):
    """Stochastic depth: drops the residual branch per sample in training;
    the identity at eval."""

    def __init__(self, rate=0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = x.new_empty((x.shape[0],) + (1,) * (x.dim() - 1)).bernoulli_(keep)
        return x / keep * mask


def round_width(width, multiplier, min_width=1, divisor=1, verbose=False):
    """Round channel width the SlowFast way (`models/utils.py` round_width)."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


def max_pool_3d(x, kernel, stride, padding):
    """Max pool on [B, T, H, W, C] with symmetric integer ``padding`` per
    axis; padded taps are -inf, as ``reduce_window`` pads them."""
    return _ndhwc(F.max_pool3d(_ncdhw(x), kernel, stride, padding))


def avg_pool_3d(x, kernel, stride, padding):
    """Average pool on [B, T, H, W, C], padded taps counted (the default)."""
    return _ndhwc(F.avg_pool3d(_ncdhw(x), kernel, stride, padding))


@torch.no_grad()
def init_weights(model, generator):
    """The reference's init (`video_model_builder.py` _init_weights): weights
    of linears and convs, and the MViT tokens and tables, truncated normal
    with std 0.02 at +-2 std; biases zero; norms one and zero. Draws on the
    CPU from ``generator``, so a seed gives the same weights on any device."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        module = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
        if isinstance(module, nn.LayerNorm):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            p.zero_()
        elif leaf.startswith("gamma_"):
            continue  # layer scale keeps its constructor value
        elif leaf.startswith("rel_pos") and getattr(module, "rel_pos_zero_init", False):
            p.zero_()
        else:
            cpu = torch.empty(p.shape, dtype=torch.float32)
            nn.init.trunc_normal_(cpu, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
            p.copy_(cpu)
