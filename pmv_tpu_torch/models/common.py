"""Shared model building blocks on channels-last [B, T, H, W, C] tensors.

Counterparts of `pmv_tpu/models/common.py`. Parameters stay float32; the
layers compute in the dtype of their input (bfloat16 activations on the
card by default, float32 in the tests), as the JAX package's ``dtype=``
modules do.
"""

import torch
import torch.nn.functional as F
from torch import nn

from pmv_tpu_torch.models.batchnorm import BatchNorm
from pmv_tpu_torch.ops.depthwise import depthwise3x3x3
from pmv_tpu_torch.parallel import mesh


class Linear(nn.Linear):
    """nn.Linear that computes in its input's dtype (weights cast per call)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class PointwiseConv(nn.Conv3d):
    """A 1x1x1 Conv3d computed as a linear over the last (channel) axis; at
    a spatial stride s it takes every s-th row and column first (the
    positions a 1x1x1 conv of stride (1, s, s) reads)."""

    def __init__(self, dim_in, dim_out, bias=True, stride=1):
        super().__init__(dim_in, dim_out, 1, stride=(1, stride, stride), bias=bias)

    def forward(self, x):
        s = self.stride[1]
        if s > 1:
            x = x[:, :, ::s, ::s]
        w = self.weight.reshape(self.out_channels, self.in_channels)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, w.to(x.dtype), bias)


def on_k1(c, w, stride, padding, dilation=(1, 1, 1), groups=1):
    """Whether a conv of weights ``w`` on ``c`` channels is the stride-1 SAME
    3x3x3 depthwise conv that K1 computes."""
    return (groups == c == w.shape[0] and tuple(w.shape[2:]) == (3, 3, 3)
            and tuple(stride) == (1, 1, 1) and tuple(padding) == (1, 1, 1)
            and tuple(dilation) == (1, 1, 1))


def t_extent(kernel, stride, padding, t, dilation=1):
    """(left, right, out): the halo planes a conv or pool of T ``kernel``,
    ``stride``, ``padding`` and ``dilation`` needs on a rank's ``t`` planes
    under sequence parallelism, and the planes it gives. The conv reads
    ``padding`` planes before a rank's first and ``span - padding - stride``
    after its last (span = the dilated kernel); every rank's ``t`` must be
    a multiple of the stride, and the conv SAME-like (T / stride planes out
    over the whole clip), so that the ranks' outputs tile the clip's."""
    span = dilation * (kernel - 1) + 1
    if t % stride:
        raise ValueError(f"a rank's {t} planes are not a multiple of the T stride {stride}: "
                         "give each rank a multiple of it (DATA.NUM_FRAMES / the model axis)")
    if not span - stride <= 2 * padding < span:
        raise NotImplementedError(f"a T kernel of {kernel}, stride {stride}, padding "
                                  f"{padding} under sequence parallelism")
    return padding, max(span - padding - stride, 0), t // stride


def _f_conv3d(x, w, bias, stride, padding, dilation, groups):
    x = x.permute(0, 4, 1, 2, 3)
    if groups > 1:
        x = x.contiguous()
    return F.conv3d(x, w, bias, stride, padding, dilation, groups).permute(0, 2, 3, 4, 1)


def _k1(x, w, bias):
    c = x.shape[-1]
    y = depthwise3x3x3(x.contiguous(), w.reshape(c, 27).t().reshape(3, 3, 3, c).contiguous())
    return y if bias is None else y + bias


def conv_on_extended(xe, w, bias, stride, padding, dilation, groups, out):
    """A rank's ``out`` output planes of the conv from ``xe``, its planes
    extended by their halo (``t_extent``; weights and bias in xe.dtype): K1
    on the whole extent (``on_k1``: one plane each side), its first and last
    output planes dropped, so that its backward runs dx through K1 and dw
    through the wgrad kernel on the same extent (dw a partial sum, which
    the gradient's all-reduce completes); every other conv ``F.conv3d``
    with T padded by 0, its first ``out`` planes."""
    if on_k1(xe.shape[-1], w, stride, padding, dilation, groups):
        return _k1(xe, w, bias)[:, 1:-1]
    y = _f_conv3d(xe, w, bias, stride, (0, *padding[1:]), dilation, groups)
    return y[:, :out]


def channels_last_conv3d(x, w, bias=None, stride=(1, 1, 1), padding=(0, 0, 0),
                         dilation=(1, 1, 1), groups=1):
    """A conv3d on [B, T, H, W, C] tensors, weights [O, I / groups, kt, kh,
    kw] as the reference keeps them, computed in x.dtype. The stride-1 SAME
    3x3x3 depthwise conv (``on_k1``) goes through ``ops.depthwise3x3x3``
    (the kernel K1 on the card; its backward dx through K1, dw through the
    wgrad kernel), then the bias; every other conv through ``F.conv3d``: a
    grouped one on a contiguous NCDHW copy, a dense one on the channels-last
    grid viewed as NCDHW, whichever layout the card ran faster (PERF.md,
    ``tools/pool_conv_variants.py [--uniformer | --x3d]``: on the view cuDNN
    runs a grouped conv one channel at a time). Inside
    ``mesh.sequence_parallel`` ``x`` is a rank's T slice, and a conv of T
    kernel or stride above 1 runs on it extended by its halo
    (``conv_on_extended``; none for a T kernel of 1, whose stride must
    divide the rank's planes)."""
    w = w.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    if mesh.active() is not None and (w.shape[2] > 1 or stride[0] > 1):
        left, right, out = t_extent(w.shape[2], stride[0], padding[0], x.shape[1],
                                    dilation[0])
        return conv_on_extended(mesh.extend_t(x, left, right), w, bias, stride, padding,
                                dilation, groups, out)
    if on_k1(x.shape[-1], w, stride, padding, dilation, groups):
        return _k1(x, w, bias)
    return _f_conv3d(x, w, bias, stride, padding, dilation, groups)


class ChannelsLastConv3d(nn.Conv3d):
    """nn.Conv3d's parameters on [B, T, H, W, C] tensors, computed by
    ``channels_last_conv3d``."""

    def on_k1(self):
        return on_k1(self.in_channels, self.weight, self.stride, self.padding, self.dilation,
                     self.groups)

    def forward(self, x):
        return channels_last_conv3d(x, self.weight, self.bias, self.stride, self.padding,
                                    self.dilation, self.groups)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics (float64 for a float64 input),
    returning its input's dtype (flax LayerNorm's float32 reductions; eps
    1e-6 as the reference)."""

    def __init__(self, dim, eps=1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        y = F.layer_norm(xf, self.normalized_shape, self.weight.to(xf.dtype),
                         self.bias.to(xf.dtype), self.eps)
        return y.to(x.dtype)


class Dropout(nn.Module):
    """Elementwise dropout, split into "sample" and "apply", so that the keep
    mask comes from a generator the caller owns (the train step), or from
    outside (a test hands the port the JAX package's masks). ``sample``
    draws the keep mask; ``forward`` applies ``x / keep * mask`` in training
    (flax ``nn.Dropout``'s ``select(mask, x / keep, 0)``) and is the
    identity at eval."""

    def __init__(self, rate=0.0):
        super().__init__()
        self.rate = rate

    def sample(self, shape, generator, device=None):
        """float32 keep mask of ``shape`` (1 keeps, 0 drops), or None when
        the rate is 0."""
        if self.rate == 0.0:
            return None
        u = torch.rand(shape, generator=generator, device=device)
        return (u < 1.0 - self.rate).float()

    def forward(self, x, mask=None):
        if self.rate == 0.0 or not self.training:
            return x
        if mask is None:
            raise ValueError(
                f"{type(self).__name__} in training applies a keep mask drawn "
                "with its sample()"
            )
        return x / (1.0 - self.rate) * self._broadcast(mask, x)

    def _broadcast(self, mask, x):
        return mask.to(device=x.device, dtype=x.dtype)


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
        self.drop = Dropout(drop_rate)

    def forward(self, x):
        x = F.gelu(self.fc1(x), approximate="tanh")
        return self.drop(self.fc2(self.drop(x)))


class DropPath(Dropout):
    """Stochastic depth: drops the residual branch per sample in training
    (a keep mask [B], as ``pmv_tpu/models/common.py::drop_path``); the
    identity at eval."""

    def sample(self, batch, generator, device=None):
        return super().sample((batch,), generator, device)

    def _broadcast(self, mask, x):
        return super()._broadcast(mask, x).reshape((-1,) + (1,) * (x.dim() - 1))


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


def _pool(pool, x, kernel, stride, padding, fill):
    """``pool`` over [B, T, H, W, C]; inside ``mesh.sequence_parallel``, of a
    T kernel above 1, on a rank's T slice extended by its halo, ``fill``
    beyond the clip's ends, T padded by 0."""
    if mesh.active() is None or kernel[0] == stride[0] == 1:
        return _ndhwc(pool(_ncdhw(x), kernel, stride, padding))
    left, right, out = t_extent(kernel[0], stride[0], padding[0], x.shape[1])
    xe = mesh.extend_t(x, left, right, fill)
    return _ndhwc(pool(_ncdhw(xe), kernel, stride, (0, *padding[1:])))[:, :out]


def max_pool_3d(x, kernel, stride, padding):
    """Max pool on [B, T, H, W, C] with symmetric integer ``padding`` per
    axis; padded taps are -inf, as ``reduce_window`` pads them."""
    return _pool(F.max_pool3d, x, tuple(kernel), tuple(stride), tuple(padding), -float("inf"))


def avg_pool_3d(x, kernel, stride, padding):
    """Average pool on [B, T, H, W, C], padded taps counted (the default)."""
    return _pool(F.avg_pool3d, x, tuple(kernel), tuple(stride), tuple(padding), None)


@torch.no_grad()
def init_weights(model, generator):
    """The reference's init (`video_model_builder.py` _init_weights): weights
    of linears and convs, and the MViT tokens and tables, truncated normal
    with std 0.02 at +-2 std; biases zero; norms one and zero; a module's
    ``init_value``, where it has one, fills its weight. Draws on the CPU
    from ``generator``, so a seed gives the same weights on any device."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        module = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
        if isinstance(module, (nn.LayerNorm, BatchNorm)):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "weight" and hasattr(module, "init_value"):
            p.fill_(module.init_value)
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


@torch.no_grad()
def init_flax_defaults(model, generator, normal_std=None):
    """flax's default initializers, for a model that the JAX package builds
    with them (X3D): conv and linear weights lecun-normal (a normal of
    variance 1 / fan_in truncated at +-2 std, std rescaled by 1 / 0.8796 as
    flax's ``variance_scaling`` does; fan_in = weight[0].numel()); biases
    zero; norms one and zero; the linear modules in ``normal_std`` (a
    {module: std} map) from an untruncated normal of that std instead. Draws
    on the CPU from ``generator``."""
    normal_std = normal_std or {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        module = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
        if isinstance(module, (nn.LayerNorm, BatchNorm)):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            p.zero_()
        else:
            cpu = torch.empty(p.shape, dtype=torch.float32)
            if module in normal_std:
                nn.init.normal_(cpu, std=normal_std[module], generator=generator)
            else:
                std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(cpu, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            p.copy_(cpu)
