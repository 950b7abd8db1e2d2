"""The ResNet family: C2D, I3D, Slow (``ResNetModel``) and SlowFast
(`MViT/slowfast/models/video_model_builder.py:401-459,1089-1577`).

Counterpart of `pmv_tpu/models/resnet.py`, on channels-last [B, T, H, W, C]
tensors, under the reference's module tree, so that a PySlowFast ``.pyth``
loads by name: ``s1.pathway{P}_stem``, the stages ``s2`` ... ``s5`` of
``pathway{P}_res{i}`` blocks (and ``pathway0_nonlocal{i}``), SlowFast's
fusions ``s1_fuse`` ... ``s4_fuse``, then ``head``.

- ``ResNetModel`` (registered "ResNet"): ``ResNetBasicStem``, four
  ``ResStage``s of RESNET.TRANS_FUNC blocks with the temporal kernels of
  ``_TEMPORAL_KERNEL_BASIS[MODEL.ARCH]``, a max pool of ``_POOL1[ARCH]``
  after ``s2``, non-local blocks at NONLOCAL.LOCATION, and
  ``ResNetBasicHead``; with ``return_features`` the last stage's grid.
- ``SlowFast`` (registered "SlowFast"): forward([slow, fast]), the slow
  pathway at 1 / SLOWFAST.ALPHA of the fast one's frames
  (``engine.steps.pack_pathways``), the fast one at 1 / BETA_INV of its
  width; after the stem and each of the first three stages
  ``FuseFastToSlow`` concatenates onto the slow pathway a strided temporal
  conv of the fast one. As the JAX package's, it builds no non-local block
  (NONLOCAL.LOCATION is read by ``ResNetModel`` only; ROADMAP.md records
  it) and has no ``return_features``.
- No conv of these nets is a stride-1 SAME 3x3x3 depthwise conv: none runs
  on the kernel K1. Every conv goes through ``common.channels_last_conv3d``
  (cuDNN on the card), as the JAX package runs them on XLA's convs.
- The initializers are flax's defaults, as in the JAX model (lecun-normal
  convs, the projection from normal(0.01), BatchNorm scales 1 but the
  non-local blocks' 0), drawn with torch. RESNET.ZERO_INIT_FINAL_BN is read
  nowhere in the JAX package and is ignored here too. No DropPath (the JAX
  nets have none).
- With DETECTION.ENABLE (the AVA recipes) the head is ``ResNetRoIHead``
  over the last stage's grid of each pathway, and the forward takes the
  clip's ``boxes`` [B, M, 4] and ``box_mask`` [B, M] and returns [B, M,
  NUM_CLASSES] (`pmv_tpu/models/resnet.py:121-133,261-273`); under
  sequence parallelism each pathway's mean over T sums over the model
  group (``heads.ResNetRoIHead``), and the boxes are whole on every rank.
- Conv-only but for the non-local blocks, whose affinity runs over every
  position, so the transposed input gives the transposed output:
  ``hw_switch`` changes nothing.
"""

import torch
import torch.nn.functional as F
from torch import nn

from pmv_tpu_torch.models.batchnorm import get_norm
from pmv_tpu_torch.models.build import MODEL_REGISTRY
from pmv_tpu_torch.models.common import init_flax_defaults, max_pool_3d
from pmv_tpu_torch.models.heads import ResNetBasicHead, ResNetRoIHead
from pmv_tpu_torch.models.nonlocal_block import Nonlocal
from pmv_tpu_torch.models.resnet_helper import PathwayStages, ResStage, conv
from pmv_tpu_torch.models.stem import ResNetBasicStem

_MODEL_STAGE_DEPTH = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

_TEMPORAL_KERNEL_BASIS = {
    "2d": [[1], [1], [1], [1], [1]],
    "c2d": [[1], [1], [1], [1], [1]],
    "slow_c2d": [[1], [1], [1], [1], [1]],
    "i3d": [[5], [3], [3, 1], [3, 1], [1, 3]],
    "slow_i3d": [[5], [3], [3, 1], [3, 1], [1, 3]],
    "slow": [[1], [1], [1], [3], [3]],
}

# Per stage, [slow, fast] temporal kernels.
_TEMPORAL_KERNEL_BASIS_SLOWFAST = [[[1], [5]], [[1], [3]], [[1], [3]], [[3], [3]], [[3], [3]]]

_POOL1 = {
    "2d": [1, 1, 1],
    "c2d": [2, 1, 1],
    "slow_c2d": [1, 1, 1],
    "i3d": [2, 1, 1],
    "slow_i3d": [1, 1, 1],
    "slow": [1, 1, 1],
}


def _stage_dims(cfg):
    """Per stage (dim_in, dim_out, dim_inner, blocks) of the slow or single
    pathway, before any fusion's channels."""
    d2, d3, d4, d5 = _MODEL_STAGE_DEPTH[cfg.RESNET.DEPTH]
    width = cfg.RESNET.WIDTH_PER_GROUP
    inner = cfg.RESNET.NUM_GROUPS * width
    return [
        (width, width * 4, inner, d2),
        (width * 4, width * 8, inner * 2, d3),
        (width * 8, width * 16, inner * 4, d4),
        (width * 16, width * 32, inner * 8, d5),
    ]


class _ResNetBase(nn.Module):
    """What the ResNet family's nets share: the init, the draws, the
    stages."""

    def __init__(self, cfg, dtype, has_detection_head=False):
        super().__init__()
        if cfg.DETECTION.ENABLE and not has_detection_head:
            raise NotImplementedError(
                f"DETECTION.ENABLE on {type(self).__name__}: the detection head is "
                "ResNet's and SlowFast's, as in the JAX package")
        self.compute_dtype = dtype
        self.detection = cfg.DETECTION.ENABLE

    def make_head(self, cfg, dim_in):
        """``ResNetBasicHead``, or with DETECTION.ENABLE ``ResNetRoIHead``,
        over pathways of widths ``dim_in``."""
        if self.detection:
            det = cfg.DETECTION
            return ResNetRoIHead(dim_in, cfg.MODEL.NUM_CLASSES, det.ROI_XFORM_RESOLUTION,
                                 det.SPATIAL_SCALE_FACTOR, cfg.MODEL.DROPOUT_RATE,
                                 cfg.MODEL.HEAD_ACT, det.ALIGNED)
        return ResNetBasicHead(dim_in, cfg.MODEL.NUM_CLASSES, cfg.MODEL.DROPOUT_RATE,
                               cfg.MODEL.HEAD_ACT)

    def run_head(self, xs, head_dropout_mask, boxes, box_mask):
        """The head on the pathways ``xs``; the detection head takes the
        boxes."""
        if not self.detection:
            return self.head(xs, head_dropout_mask)
        if boxes is None or box_mask is None:
            raise ValueError("a detection model (DETECTION.ENABLE) takes boxes and box_mask")
        return self.head(xs, boxes, box_mask, head_dropout_mask)

    def stages(self):
        return [getattr(self, f"s{i}") for i in range(2, 6)]

    def init_weights(self, generator):
        """flax's default initializers, as the JAX model's (module docstring)."""
        head = getattr(self, "head", None)  # none in a contrastive backbone
        init_flax_defaults(self, generator, {head.projection: 0.01} if head else {})
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Nonlocal):
                    m.bn.weight.zero_()

    def sample_drop_path_masks(self, batch, generator, device=None):
        """None: the ResNet family has no DropPath."""
        return None

    def sample_head_dropout_mask(self, batch, generator, device=None):
        """The head's dropout keep mask [batch, its width], or None at rate 0
        (``batch`` counts a detection head's boxes)."""
        return self.head.dropout.sample((batch, self.head.dim_in), generator, device)


class ResNetModel(_ResNetBase):
    """Config-driven single-pathway 3D ResNet (C2D, I3D, Slow).
    forward(x [B, T, H, W, 3], or [x]) -> class scores, or the last stage's
    grid [B, T', H', W', C] with ``return_features``."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__(cfg, dtype, has_detection_head=True)
        arch = cfg.MODEL.ARCH
        tk = _TEMPORAL_KERNEL_BASIS[arch]
        self.pool1 = tuple(_POOL1[arch])
        width = cfg.RESNET.WIDTH_PER_GROUP
        norm = get_norm(cfg)
        self.s1 = nn.ModuleDict({"pathway0_stem": ResNetBasicStem(
            cfg.DATA.INPUT_CHANNEL_NUM[0], width, (tk[0][0], 7, 7), (1, 2, 2),
            (tk[0][0] // 2, 3, 3),
        )})
        for s, (dim_in, dim_out, dim_inner, blocks) in enumerate(_stage_dims(cfg)):
            setattr(self, f"s{s + 2}", ResStage(
                dim_in, dim_out, dim_inner, tk[s + 1], cfg.RESNET.SPATIAL_STRIDES[s][0], blocks,
                cfg.RESNET.NUM_GROUPS, cfg.RESNET.NUM_BLOCK_TEMP_KERNEL[s][0],
                cfg.RESNET.TRANS_FUNC, cfg.RESNET.STRIDE_1X1,
                cfg.RESNET.SPATIAL_DILATIONS[s][0], norm,
                nonlocal_inds=cfg.NONLOCAL.LOCATION[s][0], nonlocal_pool=cfg.NONLOCAL.POOL[s][0],
                nonlocal_instantiation=cfg.NONLOCAL.INSTANTIATION,
            ))
        self.head = self.make_head(cfg, [width * 32])

    def forward(self, x, return_features=False, drop_path_masks=None,
                head_dropout_mask=None, hw_switch=False, boxes=None, box_mask=None):
        """``head_dropout_mask`` (``sample_head_dropout_mask``) in train mode
        when MODEL.DROPOUT_RATE > 0; ``boxes`` and ``box_mask`` with
        DETECTION.ENABLE. ``drop_path_masks`` and ``hw_switch`` change nothing
        (module docstring)."""
        if isinstance(x, (list, tuple)):
            x = x[0]
        x = self.s1["pathway0_stem"](x.to(self.compute_dtype))
        for stage in self.stages():
            x = stage(x)
            if stage is self.s2 and self.pool1 != (1, 1, 1):
                x = max_pool_3d(x, self.pool1, self.pool1, (0, 0, 0))
        if return_features:
            return x
        return self.run_head([x], head_dropout_mask, boxes, box_mask)


class FuseFastToSlow(nn.Module):
    """The fast pathway's (kernel x 1 x 1) conv ``conv_f2s`` of temporal
    stride ``alpha`` to ``ratio`` x its width, norm ``bn``, ReLU, concatenated
    onto the slow pathway's channels (`pmv_tpu/models/resnet.py:138`)."""

    def __init__(self, dim_in, ratio, kernel, alpha, norm):
        super().__init__()
        self.conv_f2s = conv(dim_in, dim_in * ratio, (kernel, 1, 1), (alpha, 1, 1),
                             (kernel // 2, 0, 0))
        self.bn = norm(dim_in * ratio)

    def forward(self, xs):
        x_s, x_f = xs
        fuse = F.relu(self.bn(self.conv_f2s(x_f)))
        return [torch.cat([x_s, fuse], dim=-1), x_f]


class SlowFast(_ResNetBase):
    """Config-driven two-pathway SlowFast. forward([slow [B, T / ALPHA, H, W,
    3], fast [B, T, H, W, 3]]) -> class scores."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__(cfg, dtype, has_detection_head=True)
        tk = _TEMPORAL_KERNEL_BASIS_SLOWFAST
        width = cfg.RESNET.WIDTH_PER_GROUP
        beta = cfg.SLOWFAST.BETA_INV
        ratio = cfg.SLOWFAST.FUSION_CONV_CHANNEL_RATIO
        res = cfg.RESNET
        norm = get_norm(cfg)

        def fuse(dim_fast):
            return FuseFastToSlow(dim_fast, ratio, cfg.SLOWFAST.FUSION_KERNEL_SZ,
                                  cfg.SLOWFAST.ALPHA, norm)

        self.s1 = nn.ModuleDict({
            f"pathway{p}_stem": ResNetBasicStem(
                cfg.DATA.INPUT_CHANNEL_NUM[p], width // (beta if p else 1),
                (tk[0][p][0], 7, 7), (1, 2, 2), (tk[0][p][0] // 2, 3, 3))
            for p in (0, 1)
        })
        self.s1_fuse = fuse(width // beta)
        for s, (dim_in, dim_out, dim_inner, blocks) in enumerate(_stage_dims(cfg)):
            slow = ResStage(
                dim_in + dim_in // beta * ratio, dim_out, dim_inner, tk[s + 1][0],
                res.SPATIAL_STRIDES[s][0], blocks, res.NUM_GROUPS,
                res.NUM_BLOCK_TEMP_KERNEL[s][0], res.TRANS_FUNC, res.STRIDE_1X1,
                res.SPATIAL_DILATIONS[s][0], norm, pathway=0,
            )
            fast = ResStage(
                dim_in // beta, dim_out // beta, dim_inner // beta, tk[s + 1][1],
                res.SPATIAL_STRIDES[s][-1], blocks, res.NUM_GROUPS,
                res.NUM_BLOCK_TEMP_KERNEL[s][-1], res.TRANS_FUNC, res.STRIDE_1X1,
                res.SPATIAL_DILATIONS[s][-1], norm, pathway=1,
            )
            setattr(self, f"s{s + 2}", PathwayStages([slow, fast]))
            if s < 3:
                setattr(self, f"s{s + 2}_fuse", fuse(dim_out // beta))
        self.head = self.make_head(cfg, [width * 32, width * 32 // beta])

    def forward(self, x, drop_path_masks=None, head_dropout_mask=None, hw_switch=False,
                boxes=None, box_mask=None):
        """``x`` is [slow, fast]; the rest as ``ResNetModel``'s."""
        if not (isinstance(x, (list, tuple)) and len(x) == 2):
            raise ValueError("SlowFast takes [slow, fast] pathway inputs (steps.pack_pathways)")
        xs = [self.s1[f"pathway{p}_stem"](x[p].to(self.compute_dtype)) for p in (0, 1)]
        xs = self.s1_fuse(xs)
        for s, stage in enumerate(self.stages()):
            xs = stage(xs)
            if s < 3:
                xs = getattr(self, f"s{s + 2}_fuse")(xs)
        return self.run_head(xs, head_dropout_mask, boxes, box_mask)


@MODEL_REGISTRY.register(name="ResNet")
def build_resnet(cfg, dtype=torch.float32):
    return ResNetModel(cfg, dtype=dtype)


@MODEL_REGISTRY.register(name="SlowFast")
def build_slowfast(cfg, dtype=torch.float32):
    return SlowFast(cfg, dtype=dtype)
