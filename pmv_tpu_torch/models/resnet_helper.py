"""3D-ResNet building blocks (`MViT/slowfast/models/resnet_helper.py`).

Counterpart of `pmv_tpu/models/resnet_helper.py`, on channels-last
[B, T, H, W, C] tensors, under the reference's names (``branch1``,
``branch1_bn``, ``branch2.{a,a_bn,b,b_bn,se.fc1,se.fc2,c,c_bn}``, a stage's
blocks ``pathway0_res{i}``), so that a PySlowFast ``.pyth`` loads by name.

- 1x1x1 convs are ``common.PointwiseConv``: a linear over the channel axis,
  the strided shortcut on every s-th row and column.
- The channelwise Tx3x3 conv is a ``common.ChannelsLastConv3d``: in all but
  the first block of a stage it is a stride-1 SAME 3x3x3 depthwise conv,
  which goes to ``ops.depthwise3x3x3`` (the kernel K1 on the card); the
  first block's, strided, to a grouped ``F.conv3d`` on a contiguous NCDHW
  copy. In
  the JAX package every one of these convs is an XLA conv; K1 computes the
  same function.
- Only the X3D transform is ported: ``BasicTransform`` and
  ``BottleneckTransform`` come with the ResNet family (M13), and
  ``ResBlock`` raises for them. Non-local blocks come with it too.
"""

import torch
import torch.nn.functional as F
from torch import nn

from pmv_tpu_torch.models.common import ChannelsLastConv3d, DropPath, PointwiseConv, round_width


class SE(nn.Module):
    """Squeeze-excitation (`resnet_helper.py:32`): the mean over T, H and W,
    fc1, ReLU (or swish), fc2, sigmoid, times the input."""

    def __init__(self, dim_in, ratio, relu_act=True):
        super().__init__()
        dim_fc = round_width(dim_in, ratio, min_width=8, divisor=8)
        self.fc1 = PointwiseConv(dim_in, dim_fc)
        self.fc2 = PointwiseConv(dim_fc, dim_in)
        self.relu_act = relu_act

    def forward(self, x):
        s = self.fc1(x.mean(dim=(1, 2, 3), keepdim=True))
        s = F.relu(s) if self.relu_act else F.silu(s)
        return x * torch.sigmoid(self.fc2(s))


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
    """The transform, drop-connect, and the shortcut (a strided 1x1x1 conv
    and a norm where the width or the grid changes), then ReLU
    (`resnet_helper.py:158`)."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, trans_func_name,
                 dim_inner, num_groups=1, stride_1x1=False, dilation=1, norm=None,
                 block_idx=0, drop_connect_rate=0.0):
        super().__init__()
        if trans_func_name != "x3d_transform":
            raise NotImplementedError(
                f"RESNET.TRANS_FUNC {trans_func_name} is not ported (the ResNet family)"
            )
        self.branch2 = X3DTransform(
            dim_in, dim_out, temp_kernel_size, stride, dim_inner, num_groups,
            stride_1x1, dilation, norm, block_idx=block_idx,
        )
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
    """One pathway's stack of ``ResBlock``s, named ``pathway0_res{i}``
    (`resnet_helper.py:214`). The temporal kernel pattern repeats over the
    blocks, then falls back to 1 past ``num_block_temp_kernel``."""

    def __init__(self, dim_in, dim_out, dim_inner, temp_kernel_sizes, stride, num_blocks,
                 num_groups, num_block_temp_kernel, trans_func_name, stride_1x1=False,
                 dilation=1, norm=None, drop_connect_rate=0.0):
        super().__init__()
        tks = (list(temp_kernel_sizes) * num_blocks)[:num_block_temp_kernel]
        tks += [1] * (num_blocks - num_block_temp_kernel)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            setattr(self, f"pathway0_res{i}", ResBlock(
                dim_in if i == 0 else dim_out, dim_out, tks[i], stride if i == 0 else 1,
                trans_func_name, dim_inner, num_groups, stride_1x1, dilation, norm,
                block_idx=i, drop_connect_rate=drop_connect_rate,
            ))

    def blocks(self):
        return [getattr(self, f"pathway0_res{i}") for i in range(self.num_blocks)]

    def sample_drop_path_masks(self, batch, generator, device=None):
        """Per block, its drop-connect keep mask [batch], or None."""
        return [b.drop_connect.sample(batch, generator, device) for b in self.blocks()]

    def forward(self, x, masks=None):
        for block, mask in zip(self.blocks(), masks or [None] * self.num_blocks):
            x = block(x, mask)
        return x
