"""Patch-embed stem (`MViT/slowfast/models/stem_helper.py` PatchEmbed).

A plain strided conv. The JAX package's TPU.FOLD_STEM layout rewrite
(`pmv_tpu/models/stem.py:165-181`) is not ported: it computes the same conv.
"""

import torch.nn.functional as F
from torch import nn


class PatchEmbed(nn.Module):
    """[B, T, H, W, C] -> (tokens [B, T'*H'*W', D], (T', H', W'))."""

    def __init__(self, dim_in, dim_out, kernel, stride, padding, conv_2d=False):
        super().__init__()
        conv = nn.Conv2d if conv_2d else nn.Conv3d
        if conv_2d:
            kernel, stride, padding = kernel[-2:], stride[-2:], padding[-2:]
        self.conv_2d = conv_2d
        self.proj = conv(dim_in, dim_out, tuple(kernel), tuple(stride),
                         tuple(padding))

    def forward(self, x):
        w = self.proj.weight.to(x.dtype)
        b = self.proj.bias.to(x.dtype)
        p = self.proj
        if self.conv_2d:
            # Per-frame 2-D conv: fold T into the batch.
            bsz, t = x.shape[:2]
            y = F.conv2d(x.flatten(0, 1).permute(0, 3, 1, 2), w, b,
                         p.stride, p.padding)
            y = y.reshape(bsz, t, *y.shape[1:]).transpose(1, 2)
        else:
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, p.stride, p.padding)
        thw = tuple(y.shape[2:])
        return y.flatten(2).transpose(1, 2), thw
