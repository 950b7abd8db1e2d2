"""3D-ResNet building blocks (`MViT/slowfast/models/resnet_helper.py`).

Counterpart of `pmv_tpu/models/resnet_helper.py`, on channels-last
[B, T, H, W, C] tensors, under the reference's names (``branch1``,
``branch1_bn``, ``branch2.{a,a_bn,b,b_bn,se.fc1,se.fc2,c,c_bn}``, a stage's
blocks ``pathway{P}_res{i}`` and non-local blocks ``pathway{P}_nonlocal{i}``),
so that a PySlowFast ``.pyth`` loads by name.

- Transforms: ``BasicTransform`` (Tx3x3, 1x3x3), ``BottleneckTransform``
  (Tx1x1, 1x3x3 with the stage's groups and dilation, 1x1x1) and
  ``X3DTransform`` (1x1x1, channelwise Tx3x3 with SE, 1x1x1).
- 1x1x1 convs are ``common.PointwiseConv``: a linear over the channel axis,
  the strided shortcut on every s-th row and column. Every other conv is a
  ``common.ChannelsLastConv3d``. X3D's channelwise Tx3x3 conv in all but the
  first block of a stage is a stride-1 SAME 3x3x3 depthwise conv, which goes
  to ``ops.depthwise3x3x3`` (the kernel K1 on the card); no conv of the
  basic or bottleneck transforms is one (none is depthwise), so they run
  on ``F.conv3d``, as they run on XLA's convs in the JAX package.
"""

import torch
import torch.nn.functional as F
from torch import nn

from pmv_tpu_torch.models.common import ChannelsLastConv3d, DropPath, PointwiseConv, round_width
from pmv_tpu_torch.models.nonlocal_block import Nonlocal
from pmv_tpu_torch.parallel import mesh


class SE(nn.Module):
    """Squeeze-excitation (`resnet_helper.py:32`): the mean over T, H and W
    (the model group's under sequence parallelism, ``mesh.t_mean``), fc1,
    ReLU (or swish), fc2, sigmoid, times the input."""

    def __init__(self, dim_in, ratio, relu_act=True):
        super().__init__()
        dim_fc = round_width(dim_in, ratio, min_width=8, divisor=8)
        self.fc1 = PointwiseConv(dim_in, dim_fc)
        self.fc2 = PointwiseConv(dim_fc, dim_in)
        self.relu_act = relu_act

    def forward(self, x):
        s = self.fc1(mesh.t_mean(x, (1, 2, 3), keepdim=True))
        s = F.relu(s) if self.relu_act else F.silu(s)
        return x * torch.sigmoid(self.fc2(s))


def conv(dim_in, dim_out, kernel, stride=(1, 1, 1), padding=(0, 0, 0), groups=1, dilation=1):
    """A bias-free conv with nn.Conv3d's parameters (`resnet_helper.py:18`
    ``_conv``, its dilation on H and W): a ``PointwiseConv`` where it is
    1x1x1, else a ``ChannelsLastConv3d``."""
    if tuple(kernel) == (1, 1, 1) and groups == 1 and stride[0] == 1 and stride[1] == stride[2]:
        return PointwiseConv(dim_in, dim_out, bias=False, stride=stride[1])
    return ChannelsLastConv3d(dim_in, dim_out, tuple(kernel), tuple(stride), tuple(padding),
                              dilation=(1, dilation, dilation), groups=groups, bias=False)


class BasicTransform(nn.Module):
    """Tx3x3 (strided), norm, ReLU, then 1x3x3 and norm
    (`resnet_helper.py:52`)."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, norm):
        super().__init__()
        tk = temp_kernel_size
        self.a = conv(dim_in, dim_out, (tk, 3, 3), (1, stride, stride), (tk // 2, 1, 1))
        self.a_bn = norm(dim_out)
        self.b = conv(dim_out, dim_out, (1, 3, 3), padding=(0, 1, 1))
        self.b_bn = norm(dim_out)

    def forward(self, x):
        return self.b_bn(self.b(F.relu(self.a_bn(self.a(x)))))


class BottleneckTransform(nn.Module):
    """Tx1x1, 1x3x3 (``num_groups``, dilated by ``dilation`` on H and W),
    1x1x1, each followed by a norm, ReLU after the first two
    (`resnet_helper.py:74`); the stride on the first conv with
    ``stride_1x1``, else on the second."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner, num_groups,
                 stride_1x1, dilation, norm):
        super().__init__()
        str1x1, str3x3 = (stride, 1) if stride_1x1 else (1, stride)
        tk = temp_kernel_size
        self.a = conv(dim_in, dim_inner, (tk, 1, 1), (1, str1x1, str1x1), (tk // 2, 0, 0))
        self.a_bn = norm(dim_inner)
        self.b = conv(dim_inner, dim_inner, (1, 3, 3), (1, str3x3, str3x3),
                      (0, dilation, dilation), groups=num_groups, dilation=dilation)
        self.b_bn = norm(dim_inner)
        self.c = conv(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = norm(dim_out)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        x = F.relu(self.b_bn(self.b(x)))
        return self.c_bn(self.c(x))


class X3DTransform(nn.Module):
    """1x1x1 -> Tx3x3 channelwise (+SE on every other block, then swish) ->
    1x1x1, each conv followed by a norm (`resnet_helper.py:108`)."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner, num_groups,
                 stride_1x1, dilation, norm, se_ratio=0.0625, swish_inner=True,
                 block_idx=0):
        super().__init__()
        str1x1, str3x3 = (stride, 1) if stride_1x1 else (1, stride)
        tk = temp_kernel_size
        self.a = PointwiseConv(dim_in, dim_inner, bias=False, stride=str1x1)
        self.a_bn = norm(dim_inner)
        self.b = ChannelsLastConv3d(
            dim_inner, dim_inner, (tk, 3, 3), (1, str3x3, str3x3),
            (tk // 2, dilation, dilation), dilation=(1, dilation, dilation),
            groups=num_groups, bias=False,
        )
        self.b_bn = norm(dim_inner)
        # SE on every other block ((block_idx + 1) % 2, `resnet_helper.py:141`).
        self.se = SE(dim_inner, se_ratio) if se_ratio > 0.0 and (block_idx + 1) % 2 else None
        self.swish_inner = swish_inner
        self.c = PointwiseConv(dim_inner, dim_out, bias=False)
        self.c_bn = norm(dim_out)

    def forward(self, x):
        x = self.b_bn(self.b(F.relu(self.a_bn(self.a(x)))))
        if self.se is not None:
            x = self.se(x)
        x = F.silu(x) if self.swish_inner else F.relu(x)
        return self.c_bn(self.c(x))


class ResBlock(nn.Module):
    """The transform of RESNET.TRANS_FUNC, drop-connect, and the shortcut (a
    strided 1x1x1 conv and a norm where the width or the grid changes), then
    ReLU (`resnet_helper.py:158`)."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, trans_func_name,
                 dim_inner, num_groups=1, stride_1x1=False, dilation=1, norm=None,
                 block_idx=0, drop_connect_rate=0.0):
        super().__init__()
        if trans_func_name == "basic_transform":
            self.branch2 = BasicTransform(dim_in, dim_out, temp_kernel_size, stride, norm)
        elif trans_func_name == "bottleneck_transform":
            self.branch2 = BottleneckTransform(
                dim_in, dim_out, temp_kernel_size, stride, dim_inner, num_groups,
                stride_1x1, dilation, norm,
            )
        elif trans_func_name == "x3d_transform":
            self.branch2 = X3DTransform(
                dim_in, dim_out, temp_kernel_size, stride, dim_inner, num_groups,
                stride_1x1, dilation, norm, block_idx=block_idx,
            )
        else:
            raise NotImplementedError(f"RESNET.TRANS_FUNC {trans_func_name} is not supported")
        self.drop_connect = DropPath(drop_connect_rate)
        if dim_in != dim_out or stride != 1:
            self.branch1 = PointwiseConv(dim_in, dim_out, bias=False, stride=stride)
            self.branch1_bn = norm(dim_out)
        else:
            self.branch1 = None

    def forward(self, x, mask=None):
        f_x = self.drop_connect(self.branch2(x), mask)
        if self.branch1 is not None:
            x = self.branch1_bn(self.branch1(x))
        return F.relu(x + f_x)


class ResStage(nn.Module):
    """One pathway's stack of ``ResBlock``s, named ``pathway{P}_res{i}``, with
    a ``Nonlocal`` block ``pathway{P}_nonlocal{i}`` after each block i of
    ``nonlocal_inds`` (of width ``dim_out``, inner width ``dim_out // 2``;
    `resnet_helper.py:214`). The temporal kernel pattern repeats over the
    blocks, then falls back to 1 past ``num_block_temp_kernel``."""

    def __init__(self, dim_in, dim_out, dim_inner, temp_kernel_sizes, stride, num_blocks,
                 num_groups, num_block_temp_kernel, trans_func_name, stride_1x1=False,
                 dilation=1, norm=None, drop_connect_rate=0.0, nonlocal_inds=(),
                 nonlocal_pool=(1, 2, 2), nonlocal_instantiation="dot_product", pathway=0):
        super().__init__()
        tks = (list(temp_kernel_sizes) * num_blocks)[:num_block_temp_kernel]
        tks += [1] * (num_blocks - num_block_temp_kernel)
        self.num_blocks = num_blocks
        self.block_names = [f"pathway{pathway}_res{i}" for i in range(num_blocks)]
        self.layers = []  # every block's name, in order, the non-local ones included
        for i, name in enumerate(self.block_names):
            setattr(self, name, ResBlock(
                dim_in if i == 0 else dim_out, dim_out, tks[i], stride if i == 0 else 1,
                trans_func_name, dim_inner, num_groups, stride_1x1, dilation, norm,
                block_idx=i, drop_connect_rate=drop_connect_rate,
            ))
            self.layers.append(name)
            if i in tuple(nonlocal_inds):
                name = f"pathway{pathway}_nonlocal{i}"
                setattr(self, name, Nonlocal(dim_out, dim_out // 2, nonlocal_pool,
                                             nonlocal_instantiation))
                self.layers.append(name)

    def blocks(self):
        return [getattr(self, name) for name in self.block_names]

    def sample_drop_path_masks(self, batch, generator, device=None):
        """Per block, its drop-connect keep mask [batch], or None."""
        return [b.drop_connect.sample(batch, generator, device) for b in self.blocks()]

    def forward(self, x, masks=None):
        return run_layers(self, self.layers, x, masks)


def run_layers(module, layers, x, masks=None):
    """``x`` through ``module``'s children named ``layers`` in order, each
    ``ResBlock`` with its drop-connect mask from ``masks`` (one a block, or
    None)."""
    masks = iter(masks or [])
    for name in layers:
        layer = getattr(module, name)
        x = layer(x, next(masks, None)) if isinstance(layer, ResBlock) else layer(x)
    return x


class PathwayStages(nn.Module):
    """One stage of a multi-pathway net (SlowFast): the ``ResStage`` of each
    pathway, whose blocks it holds under their own names, as the reference's
    multi-pathway ``ResStage`` does (``s2.pathway0_res0``,
    ``s2.pathway1_res0``, ...). forward([x_0, x_1, ...]) -> a list."""

    def __init__(self, stages):
        super().__init__()
        self.pathway_layers = [stage.layers for stage in stages]
        for stage in stages:
            for name, module in stage.named_children():
                self.add_module(name, module)

    def forward(self, xs):
        return [run_layers(self, layers, x) for layers, x in zip(self.pathway_layers, xs)]
