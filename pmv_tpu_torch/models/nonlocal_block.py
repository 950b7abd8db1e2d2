"""Non-local blocks (`MViT/slowfast/models/nonlocal_helper.py`).

Counterpart of `pmv_tpu/models/nonlocal_block.py`, on channels-last
[B, T, H, W, C] tensors, under the reference's names (``conv_theta``,
``conv_phi``, ``conv_g``, ``conv_out``, ``bn``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from pmv_tpu_torch.models.batchnorm import BatchNorm
from pmv_tpu_torch.models.common import PointwiseConv, max_pool_3d
from pmv_tpu_torch.parallel import mesh


class Nonlocal(nn.Module):
    """theta, phi and g (1x1x1 convs with bias; phi and g on the input max
    pooled by ``pool_size`` where any of it is above 1), the affinity
    theta phi^T over every position of the clip, as a softmax of the
    products scaled by ``dim_inner ** -0.5`` ("softmax") or the products
    over the count of positions ("dot_product"), times g, then ``conv_out``,
    BatchNorm and the residual (`nonlocal_block.py:15`). The two products are
    ``torch.matmul``s, as the JAX package's are einsums. Under sequence
    parallelism (``parallel/mesh.py``) theta holds the rank's positions and
    phi and g, pooled on the rank's planes, are gathered over the model
    group in one ``mesh.gather_t``, so that each of the rank's positions attends
    to every position of the clip; the output is the rank's. The BatchNorm's
    scale starts at 0, so that a new block is the identity: the model's
    ``init_weights`` sets it."""

    def __init__(self, dim, dim_inner, pool_size=None, instantiation="softmax"):
        super().__init__()
        if instantiation not in ("softmax", "dot_product"):
            raise NotImplementedError(f"NONLOCAL.INSTANTIATION {instantiation}")
        self.dim_inner = dim_inner
        self.pool_size = (tuple(pool_size) if pool_size is not None
                          and any(s > 1 for s in pool_size) else None)
        self.instantiation = instantiation
        self.conv_theta = PointwiseConv(dim, dim_inner)
        self.conv_phi = PointwiseConv(dim, dim_inner)
        self.conv_g = PointwiseConv(dim, dim_inner)
        self.conv_out = PointwiseConv(dim_inner, dim)
        self.bn = BatchNorm(dim)

    def forward(self, x):
        b, t, h, w, _ = x.shape
        theta = self.conv_theta(x).reshape(b, -1, self.dim_inner)
        pooled = x if self.pool_size is None else max_pool_3d(
            x, self.pool_size, self.pool_size, (0, 0, 0))
        phi, g = self.conv_phi(pooled), self.conv_g(pooled)
        if mesh.active() is not None:  # one gather for both
            phi, g = mesh.gather_t(torch.cat([phi, g], dim=-1)).split(self.dim_inner, dim=-1)
        phi = phi.reshape(b, -1, self.dim_inner)
        g = g.reshape(b, -1, self.dim_inner)
        attn = theta @ phi.transpose(1, 2)
        if self.instantiation == "softmax":
            attn = F.softmax(attn * self.dim_inner ** -0.5, dim=-1)
        else:
            attn = attn / attn.shape[-1]
        out = (attn @ g).reshape(b, t, h, w, self.dim_inner)
        return x + self.bn(self.conv_out(out))
