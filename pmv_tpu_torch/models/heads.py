"""Classification heads (`MViT/slowfast/models/head_helper.py`)."""

import torch
import torch.nn.functional as F
from torch import nn

from pmv_tpu_torch.models.batchnorm import BatchNorm
from pmv_tpu_torch.models.common import Dropout, Linear, PointwiseConv
from pmv_tpu_torch.ops.roi_align import roi_align
from pmv_tpu_torch.parallel import mesh


def head_act(x, act_func):
    """The eval-time head activation, computed in float32."""
    if act_func == "softmax":
        return x.float().softmax(dim=-1)
    if act_func == "sigmoid":
        return x.float().sigmoid()
    if act_func == "none" or act_func is None:
        return x
    raise NotImplementedError(f"{act_func} head activation unsupported")


class TransformerBasicHead(nn.Module):
    """Dropout + linear, then the activation at eval only
    (`head_helper.py:502-577`, without the contrastive projection MLP).
    In training the dropout applies ``dropout_mask`` [B, dim_in], drawn
    with ``self.dropout.sample``."""

    def __init__(self, dim_in, num_classes, dropout_rate=0.0,
                 act_func="softmax", detach_final_fc=False):
        super().__init__()
        self.dim_in = dim_in
        self.dropout = Dropout(dropout_rate)
        self.projection = Linear(dim_in, num_classes)
        self.act_func = act_func
        self.detach_final_fc = detach_final_fc

    def forward(self, x, dropout_mask=None):
        x = self.dropout(x, dropout_mask)
        if self.detach_final_fc:
            x = x.detach()
        x = self.projection(x)
        if not self.training:
            x = head_act(x, self.act_func)
        return x


class ResNetBasicHead(nn.Module):
    """The ResNet family's head (`pmv_tpu/models/heads.py:54`): per pathway
    the mean over T, H and W, the pathways concatenated, dropout, the
    ``projection`` linear; the activation at eval only. ``dim_in`` lists the
    pathways' widths. In training the dropout applies ``dropout_mask``
    [B, sum(dim_in)], drawn with ``self.dropout.sample``. Under sequence
    parallelism a pathway's mean is the model group's (``mesh.t_mean``),
    but for the pathways ``replicated`` lists, which every rank holds whole
    (AVSlowFast's audio)."""

    def __init__(self, dim_in, num_classes, dropout_rate=0.0, act_func="softmax",
                 replicated=()):
        super().__init__()
        self.dim_in = sum(dim_in)
        self.replicated = tuple(replicated)
        self.dropout = Dropout(dropout_rate)
        self.projection = Linear(self.dim_in, num_classes)
        self.act_func = act_func

    def forward(self, inputs, dropout_mask=None):
        x = torch.cat([x.mean(dim=(1, 2, 3)) if p in self.replicated
                       else mesh.t_mean(x, (1, 2, 3)) for p, x in enumerate(inputs)], dim=-1)
        x = self.projection(self.dropout(x, dropout_mask))
        if not self.training:
            x = head_act(x, self.act_func)
        return x


class ResNetRoIHead(nn.Module):
    """The detection head (`pmv_tpu/models/heads.py:88`): per pathway the
    mean over T, RoIAlign of each box at ``resolution``^2 (``spatial_scale``
    1 / ``spatial_scale_factor``), the max over the bins; the pathways
    concatenated, dropout, the ``projection`` linear in the trunk's dtype,
    the activation at eval only; rows of padded boxes times ``box_mask``
    (0). RoIAlign, the max and the dropout run in float32 (float64 for float64
    grids). The max is ``torch.amax``, whose gradient is shared evenly among
    equal maxima, as JAX's is (bins over a flat region tie). ``inputs`` [B, T, H, W, C] per pathway, ``boxes`` [B, M, 4] in the
    clip's pixels, ``box_mask`` [B, M] -> [B, M, num_classes]. In training
    the dropout applies ``dropout_mask`` [B x M, sum(dim_in)], drawn with
    ``self.dropout.sample``. Under sequence parallelism a pathway's mean
    over T is the model group's (``mesh.t_mean``), and every rank pools the
    whole boxes from it."""

    def __init__(self, dim_in, num_classes, resolution=7, spatial_scale_factor=16,
                 dropout_rate=0.0, act_func="sigmoid", aligned=True):
        super().__init__()
        self.dim_in = sum(dim_in)
        self.resolution = resolution
        self.spatial_scale = 1.0 / spatial_scale_factor
        self.aligned = aligned
        self.dropout = Dropout(dropout_rate)
        self.projection = Linear(self.dim_in, num_classes)
        self.act_func = act_func

    def forward(self, inputs, boxes, box_mask, dropout_mask=None):
        b, m = boxes.shape[:2]
        flat = boxes.reshape(b * m, 4)
        batch_idx = torch.arange(b, device=boxes.device).repeat_interleave(m)
        pooled = [
            torch.amax(roi_align(mesh.t_mean(x, (1,)), flat, batch_idx,
                                 (self.resolution, self.resolution), self.spatial_scale,
                                 aligned=self.aligned), dim=(1, 2))
            for x in inputs
        ]
        x = self.dropout(torch.cat(pooled, dim=-1), dropout_mask)
        x = self.projection(x.to(inputs[0].dtype))
        if not self.training:
            x = head_act(x, self.act_func)
        x = x.reshape(b, m, -1)
        return x * box_mask[..., None].to(x.dtype)


class X3DHead(nn.Module):
    """X3D's head (`pmv_tpu/models/heads.py:136`): 1x1x1 ``conv_5`` to
    ``dim_inner``, BatchNorm, ReLU, the mean over T, H and W, 1x1x1 ``lin_5``
    to ``dim_out`` (then BatchNorm with ``bn_lin5_on``), ReLU, dropout, the
    ``projection`` linear; the activation at eval only. In training the
    dropout applies ``dropout_mask`` [B, dim_out], drawn with
    ``self.dropout.sample``. Under sequence parallelism the mean is the
    model group's (``mesh.t_mean``)."""

    def __init__(self, dim_in, dim_inner, dim_out, num_classes, dropout_rate=0.5,
                 act_func="softmax", bn_lin5_on=False):
        super().__init__()
        self.dim_out = dim_out
        self.conv_5 = PointwiseConv(dim_in, dim_inner, bias=False)
        self.conv_5_bn = BatchNorm(dim_inner)
        self.lin_5 = PointwiseConv(dim_inner, dim_out, bias=False)
        self.lin_5_bn = BatchNorm(dim_out) if bn_lin5_on else None
        self.dropout = Dropout(dropout_rate)
        self.projection = Linear(dim_out, num_classes)
        self.act_func = act_func

    def forward(self, x, dropout_mask=None):
        x = F.relu(self.conv_5_bn(self.conv_5(x)))
        x = self.lin_5(mesh.t_mean(x, (1, 2, 3)))
        if self.lin_5_bn is not None:
            x = self.lin_5_bn(x)
        x = self.projection(self.dropout(F.relu(x), dropout_mask))
        if not self.training:
            x = head_act(x, self.act_func)
        return x
