"""X3D (`MViT/slowfast/models/video_model_builder.py:1580-1723`).

Counterpart of `pmv_tpu/models/x3d.py`, on channels-last [B, T, H, W, C]
tensors, under the reference's module tree: ``s1.pathway0_stem``, the
stages ``s2`` ... ``s5`` of ``pathway0_res{i}`` blocks, then ``head``, so
that a PySlowFast X3D ``.pyth`` loads by name.

- A progressive-expansion 3D ResNet: the channel-separated ``X3DStem``, four
  stages of ``X3DTransform`` blocks (1x1x1, channelwise Tx3x3 with SE on
  every other block and swish, 1x1x1; the first block of a stage strided
  (1, 2, 2)), and ``X3DHead``. Every norm is BN.NORM_TYPE's
  (``batchnorm.get_norm``), the stem's and the head's plain BatchNorm.
- X3D-M (configs/Kinetics/X3D_M.yaml) has 26 blocks; the channelwise convs
  of the 22 that are not strided are stride-1 SAME 3x3x3 depthwise convs,
  the kernel K1 on the card (``common.ChannelsLastConv3d``).
- The initializers are flax's defaults, as in the JAX model (lecun-normal
  convs and linears, the projection from normal(0.01)), drawn with torch:
  the numbers differ from JAX's, the distributions do not.
  RESNET.ZERO_INIT_FINAL_BN is read nowhere in the JAX package and is
  ignored here too.
- The net is conv-only, so the portrait specialization is the same module
  on the transposed input: ``hw_switch`` changes nothing. TPU.FOLD_STEM
  is not ported (the same conv).
"""

import math

import torch
from torch import nn

from pmv_tpu_torch.models.batchnorm import get_norm
from pmv_tpu_torch.models.build import MODEL_REGISTRY
from pmv_tpu_torch.models.common import init_flax_defaults, round_width
from pmv_tpu_torch.models.heads import X3DHead
from pmv_tpu_torch.models.resnet_helper import ResStage
from pmv_tpu_torch.models.stem import X3DStem


class X3D(nn.Module):
    """Config-driven X3D. forward(x [B, T, H, W, 3]) -> class scores, or the
    last stage's grid [B, T, H', W', C] with ``return_features``."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        x3d = cfg.X3D
        norm = get_norm(cfg)
        exp_stage = 2.0
        dim_res2 = round_width(x3d.DIM_C1, exp_stage, divisor=8) if x3d.SCALE_RES2 else x3d.DIM_C1
        dim_res3 = round_width(dim_res2, exp_stage, divisor=8)
        dim_res4 = round_width(dim_res3, exp_stage, divisor=8)
        dim_res5 = round_width(dim_res4, exp_stage, divisor=8)
        block_basis = [[1, dim_res2, 2], [2, dim_res3, 2], [5, dim_res4, 2], [3, dim_res5, 2]]

        dim_in = round_width(x3d.DIM_C1, x3d.WIDTH_FACTOR)
        self.s1 = nn.ModuleDict({"pathway0_stem": X3DStem(
            cfg.DATA.INPUT_CHANNEL_NUM[0], dim_in, (5, 3, 3), (1, 2, 2), (2, 1, 1),
        )})
        for stage, (depth, width, stride) in enumerate(block_basis):
            dim_out = round_width(width, x3d.WIDTH_FACTOR)
            dim_inner = int(x3d.BOTTLENECK_FACTOR * dim_out)
            n_rep = int(math.ceil(x3d.DEPTH_FACTOR * depth)) if x3d.DEPTH_FACTOR else depth
            setattr(self, f"s{stage + 2}", ResStage(
                dim_in, dim_out, dim_inner, (3,), stride, n_rep,
                dim_inner if x3d.CHANNELWISE_3x3x3 else cfg.RESNET.NUM_GROUPS, n_rep,
                cfg.RESNET.TRANS_FUNC, cfg.RESNET.STRIDE_1X1,
                cfg.RESNET.SPATIAL_DILATIONS[stage][0], norm,
                drop_connect_rate=cfg.MODEL.DROPCONNECT_RATE * (stage + 2) / (len(block_basis) + 1),
            ))
            dim_in = dim_out
        self.features = nn.Identity()  # the Grad-CAM tap (visualization/gradcam.py)
        self.head = X3DHead(
            dim_in, dim_inner, x3d.DIM_C5, cfg.MODEL.NUM_CLASSES, cfg.MODEL.DROPOUT_RATE,
            cfg.MODEL.HEAD_ACT, x3d.BN_LIN5,
        )

    def stages(self):
        return [getattr(self, f"s{i}") for i in range(2, 6)]

    def init_weights(self, generator):
        """flax's default initializers, as the JAX model's (module docstring)."""
        head = getattr(self, "head", None)  # none in a contrastive backbone
        init_flax_defaults(self, generator, {head.projection: 0.01} if head else {})

    def sample_drop_path_masks(self, batch, generator, device=None):
        """Per stage, per block, the drop-connect keep masks of one train-mode
        forward, drawn from ``generator`` (None where the rate is 0)."""
        return [stage.sample_drop_path_masks(batch, generator, device) for stage in self.stages()]

    def sample_head_dropout_mask(self, batch, generator, device=None):
        """The head's dropout keep mask [batch, DIM_C5], or None at rate 0."""
        return self.head.dropout.sample((batch, self.head.dim_out), generator, device)

    def forward(self, x, return_features=False, drop_path_masks=None,
                head_dropout_mask=None, hw_switch=False):
        """``drop_path_masks`` (``sample_drop_path_masks``) in train mode when
        MODEL.DROPCONNECT_RATE > 0, ``head_dropout_mask``
        (``sample_head_dropout_mask``) when MODEL.DROPOUT_RATE > 0.
        ``hw_switch`` changes nothing (conv-only)."""
        x = self.s1["pathway0_stem"](x.to(self.compute_dtype))
        for stage, masks in zip(self.stages(), drop_path_masks or [None] * 4):
            x = stage(x, masks)
        x = self.features(x)
        if return_features:
            return x
        return self.head(x, head_dropout_mask)


@MODEL_REGISTRY.register(name="X3D")
def build_x3d(cfg, dtype=torch.float32):
    return X3D(cfg, dtype=dtype)
