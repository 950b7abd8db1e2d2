"""Stems (`MViT/slowfast/models/stem_helper.py`): MViT's ``PatchEmbed``,
the ResNet family's ``ResNetBasicStem`` and X3D's ``X3DStem``.

Plain convs. The JAX package's TPU.FOLD_STEM layout rewrite
(`pmv_tpu/models/stem.py:165-360`, ``use_fold`` of ``ResNetBasicStem`` and
``X3DStem``: the strided stem conv with its stride blocks, and for narrow
outputs a block of output positions, folded into channels; BatchNorm in the
folded layout) is not ported: it computes the same conv and BatchNorm on
the same parameters.
"""

import torch.nn.functional as F
from torch import nn

from pmv_tpu_torch.models.batchnorm import BatchNorm
from pmv_tpu_torch.models.common import ChannelsLastConv3d, max_pool_3d


class PatchEmbed(nn.Module):
    """[B, T, H, W, C] -> (tokens [B, T'*H'*W', D], (T', H', W')). Under
    sequence parallelism (``parallel/mesh.py``) ``x`` is a rank's frames:
    MViT's (3, 7, 7) / (2, 4, 4) conv, padded (1, 3, 3), reads one frame of
    the previous rank's (``common.t_extent``), and a rank's frames that its
    T stride does not divide raise ValueError."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding, conv_2d=False):
        super().__init__()
        conv = nn.Conv2d if conv_2d else ChannelsLastConv3d
        if conv_2d:
            kernel, stride, padding = kernel[-2:], stride[-2:], padding[-2:]
        self.conv_2d = conv_2d
        self.proj = conv(dim_in, dim_out, tuple(kernel), tuple(stride),
                         tuple(padding))

    def out_grid(self, thw):
        """The (T', H', W') grid of the tokens from a clip of ``thw``."""
        p = self.proj
        thw = list(thw)
        sizes = thw[1:] if self.conv_2d else thw
        out = [(s + 2 * pd - k) // st + 1
               for s, k, st, pd in zip(sizes, p.kernel_size, p.stride, p.padding)]
        return tuple(thw[:1] + out if self.conv_2d else out)

    def forward(self, x):
        p = self.proj
        if self.conv_2d:
            # Per-frame 2-D conv: fold T into the batch.
            bsz, t = x.shape[:2]
            y = F.conv2d(x.flatten(0, 1).permute(0, 3, 1, 2), p.weight.to(x.dtype),
                         p.bias.to(x.dtype), p.stride, p.padding)
            y = y.reshape(bsz, t, *y.shape[1:]).permute(0, 1, 3, 4, 2)
        else:
            y = p(x)
        return y.flatten(1, 3), tuple(y.shape[1:4])


class ResNetBasicStem(nn.Module):
    """A kt x kh x kw conv ``conv`` (no bias), BatchNorm ``bn``, ReLU, then
    the 1x3x3 max pool of stride (1, 2, 2) (`pmv_tpu/models/stem.py:277`);
    on [B, T, H, W, C] tensors."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding):
        super().__init__()
        self.conv = ChannelsLastConv3d(dim_in, dim_out, tuple(kernel), tuple(stride),
                                       tuple(padding), bias=False)
        self.bn = BatchNorm(dim_out)

    def forward(self, x):
        x = F.relu(self.bn(self.conv(x)))
        return max_pool_3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class X3DStem(nn.Module):
    """Channel-separated stem (`pmv_tpu/models/stem.py:361`): a 1 x kh x kw
    spatial conv ``conv_xy``, then a kt x 1 x 1 depthwise temporal conv
    ``conv``, BatchNorm ``bn`` and ReLU; on [B, T, H, W, C] tensors."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding):
        super().__init__()
        self.conv_xy = ChannelsLastConv3d(
            dim_in, dim_out, (1, kernel[1], kernel[2]), (1, stride[1], stride[2]),
            (0, padding[1], padding[2]), bias=False,
        )
        self.conv = ChannelsLastConv3d(
            dim_out, dim_out, (kernel[0], 1, 1), (stride[0], 1, 1), (padding[0], 0, 0),
            groups=dim_out, bias=False,
        )
        self.bn = BatchNorm(dim_out)

    def forward(self, x):
        return F.relu(self.bn(self.conv(self.conv_xy(x))))
