"""CSN (channel-separated networks, ir-CSN) and R(2+1)D
(`MViT/slowfast/models/ptv_model_builder.py:521-603` PTVCSN, `:606-699`
PTVR2plus1D).

Counterpart of `pmv_tpu/models/csn_r2plus1d.py`, on channels-last
[B, T, H, W, C] tensors, under the JAX package's module names:
``s1.stem_conv``, ``s1.stem_bn``, the stages ``s2`` ... ``s5`` of blocks
``res{i}`` (``branch2.{a,a_bn,b,b_bn,c,c_bn}``, R(2+1)D's
``branch2.{b_xy,b_xy_bn,b_t}`` in place of ``b``, and the shortcut's
``branch1``, ``branch1_bn``), then ``head.projection``; so that
``utils/weights.state_dict_from_jax`` maps a JAX tree onto the port's.

- One trunk, ``SeparatedConvNet``: a stem, four stages of bottleneck blocks
  (depths of RESNET.DEPTH: 18, 50, 101, 152), each block's shortcut a
  strided 1x1x1 conv and a norm where the width or the grid changes, and
  ``ResNetBasicHead``.
- CSN: stem 3x7x7 of stride (1, 2, 2), then a 1x3x3 max pool of stride
  (1, 2, 2) (padded taps -inf); ``CSNTransform``'s conv_b is a depthwise
  3x3x3 conv carrying the first block's stride, (1, 1, 1), then (2, 2, 2)
  in stages 3-5. The stride-1 ones are stride-1 SAME 3x3x3 depthwise convs:
  ``common.ChannelsLastConv3d`` sends them to ``ops.depthwise3x3x3``, the
  kernel K1 on the card (30 a forward at depth 101: 3 + 3 + 22 + 2); the
  3 strided ones run on the grouped ``F.conv3d``, as X3D's do.
- R(2+1)D: stem 1x7x7 of stride (1, 2, 2), no pool; ``R2Plus1dTransform``
  factors conv_b into a 1x3x3 spatial conv (the spatial stride) to the
  parameter-matched middle width 27 c^2 / 12 c (floored; 144, 288, 576,
  1152 at width 64), a norm and ReLU, then a 3x1x1 temporal conv (the
  temporal stride) back to c. Spatial strides 2, 2, 2, 2; temporal 1, 1,
  2, 2. No conv of it is on K1.
- The stem is one plain conv: the JAX package's TPU.FOLD_STEM computes the
  same conv in a TPU layout.
- The initializers are flax's defaults, as in the JAX model (lecun-normal
  convs, the projection from normal(0.01)), drawn with torch. The head's
  dropout mask is drawn outside the step (``sample_head_dropout_mask``), as
  the ResNet family's is. Conv-only: ``hw_switch`` changes nothing.
"""

import torch
import torch.nn.functional as F
from torch import nn

from pmv_tpu_torch.models.batchnorm import get_norm
from pmv_tpu_torch.models.build import MODEL_REGISTRY
from pmv_tpu_torch.models.common import ChannelsLastConv3d, max_pool_3d
from pmv_tpu_torch.models.heads import ResNetBasicHead
from pmv_tpu_torch.models.resnet import _ResNetBase
from pmv_tpu_torch.models.resnet_helper import conv

_MODEL_STAGE_DEPTH = {
    18: (2, 2, 2, 2),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class CSNTransform(nn.Module):
    """1x1x1 -> depthwise 3x3x3 (the block's stride) -> 1x1x1, each followed
    by a norm, ReLU after the first two (`csn_r2plus1d.py:45-67`)."""

    def __init__(self, dim_in, dim_out, dim_inner, stride, norm):
        super().__init__()
        self.a = conv(dim_in, dim_inner, (1, 1, 1))
        self.a_bn = norm(dim_inner)
        self.b = ChannelsLastConv3d(dim_inner, dim_inner, (3, 3, 3), tuple(stride), (1, 1, 1),
                                    groups=dim_inner, bias=False)
        self.b_bn = norm(dim_inner)
        self.c = conv(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = norm(dim_out)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        x = F.relu(self.b_bn(self.b(x)))
        return self.c_bn(self.c(x))


class R2Plus1dTransform(nn.Module):
    """1x1x1 -> 1x3x3 spatial (the spatial stride) -> 3x1x1 temporal (the
    temporal stride) -> 1x1x1, each followed by a norm, ReLU after all but
    the last (`csn_r2plus1d.py:70-101`)."""

    def __init__(self, dim_in, dim_out, dim_inner, stride, norm):
        super().__init__()
        st, ss = stride[0], stride[1]
        c = dim_inner
        mid = (3 * 9 * c * c) // (9 * c + 3 * c)  # Tran et al. CVPR'18 eq. 3, t = d = 3
        self.a = conv(dim_in, dim_inner, (1, 1, 1))
        self.a_bn = norm(dim_inner)
        self.b_xy = conv(dim_inner, mid, (1, 3, 3), (1, ss, ss), (0, 1, 1))
        self.b_xy_bn = norm(mid)
        self.b_t = conv(mid, dim_inner, (3, 1, 1), (st, 1, 1), (1, 0, 0))
        self.b_bn = norm(dim_inner)
        self.c = conv(dim_inner, dim_out, (1, 1, 1))
        self.c_bn = norm(dim_out)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        x = F.relu(self.b_xy_bn(self.b_xy(x)))
        x = F.relu(self.b_bn(self.b_t(x)))
        return self.c_bn(self.c(x))


class SepBlock(nn.Module):
    """``branch2`` (the transform) plus the input, through ``branch1`` (a
    1x1x1 conv of the block's stride) and ``branch1_bn`` where the width or
    the grid changes, then ReLU (`csn_r2plus1d.py:104-131`)."""

    def __init__(self, dim_in, dim_out, dim_inner, stride, transform, norm):
        super().__init__()
        self.branch2 = transform(dim_in, dim_out, dim_inner, stride, norm)
        if dim_in != dim_out or tuple(stride) != (1, 1, 1):
            self.branch1 = conv(dim_in, dim_out, (1, 1, 1), tuple(stride))
            self.branch1_bn = norm(dim_out)
        else:
            self.branch1 = None

    def forward(self, x):
        f_x = self.branch2(x)
        if self.branch1 is not None:
            x = self.branch1_bn(self.branch1(x))
        return F.relu(x + f_x)


class SeparatedConvNet(_ResNetBase):
    """The CSN / R(2+1)D trunk (`csn_r2plus1d.py:134-217`). forward(x [B, T,
    H, W, 3], or [x]) -> class scores."""

    def __init__(self, cfg, variant, dtype=torch.float32):
        super().__init__(cfg, dtype)
        norm = get_norm(cfg)
        width = cfg.RESNET.WIDTH_PER_GROUP
        if variant == "csn":
            stem_kernel, stem_pad = (3, 7, 7), (1, 3, 3)
            spatial_strides, temporal_strides = (1, 2, 2, 2), (1, 2, 2, 2)
            transform = CSNTransform
        else:
            stem_kernel, stem_pad = (1, 7, 7), (0, 3, 3)
            spatial_strides, temporal_strides = (2, 2, 2, 2), (1, 1, 2, 2)
            transform = R2Plus1dTransform
        self.pool = variant == "csn"
        self.s1 = nn.ModuleDict({
            "stem_conv": conv(cfg.DATA.INPUT_CHANNEL_NUM[0], width, stem_kernel, (1, 2, 2),
                              stem_pad),
            "stem_bn": norm(width),
        })
        dim_in = width
        for si, blocks in enumerate(_MODEL_STAGE_DEPTH[cfg.RESNET.DEPTH]):
            dim_inner = width * 2 ** si
            dim_out = dim_inner * 4
            stride = (temporal_strides[si], spatial_strides[si], spatial_strides[si])
            stage = nn.Module()
            for bi in range(blocks):
                stage.add_module(f"res{bi}", SepBlock(
                    dim_in if bi == 0 else dim_out, dim_out, dim_inner,
                    stride if bi == 0 else (1, 1, 1), transform, norm))
            setattr(self, f"s{si + 2}", stage)
            dim_in = dim_out
        self.head = ResNetBasicHead([dim_in], cfg.MODEL.NUM_CLASSES, cfg.MODEL.DROPOUT_RATE,
                                    cfg.MODEL.HEAD_ACT)

    def forward(self, x, drop_path_masks=None, head_dropout_mask=None, hw_switch=False):
        """``head_dropout_mask`` (``sample_head_dropout_mask``) in train mode
        when MODEL.DROPOUT_RATE > 0. ``drop_path_masks`` and ``hw_switch``
        change nothing (no DropPath; conv-only)."""
        if isinstance(x, (list, tuple)):
            x = x[0]
        x = x.to(self.compute_dtype)
        x = F.relu(self.s1["stem_bn"](self.s1["stem_conv"](x)))
        if self.pool:
            x = max_pool_3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for stage in self.stages():
            for block in stage.children():
                x = block(x)
        return self.head([x], head_dropout_mask)


def build_csn(cfg, dtype=torch.float32):
    return SeparatedConvNet(cfg, "csn", dtype=dtype)


def build_r2plus1d(cfg, dtype=torch.float32):
    return SeparatedConvNet(cfg, "r2plus1d", dtype=dtype)


# The reference's names and the plain aliases (`csn_r2plus1d.py:230-233`).
MODEL_REGISTRY.register(build_csn, name="PTVCSN")
MODEL_REGISTRY.register(build_csn, name="CSN")
MODEL_REGISTRY.register(build_r2plus1d, name="PTVR2plus1D")
MODEL_REGISTRY.register(build_r2plus1d, name="R2Plus1D")
