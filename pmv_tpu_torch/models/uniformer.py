"""UniFormer (`Uniformer/slowfast/models/uniformer.py`).

Counterpart of `pmv_tpu/models/uniformer.py`, on channels-last
[B, T, H, W, C] tensors, under the reference's parameter names
(``patch_embed1.proj``, ``blocks1.0.pos_embed``, ``blocks3.0.attn.qkv``,
``norm``, ``head``, ...), so that its ``.pyth`` files load by name.

- Stages 1-2 are ``CBlock``s (a BatchNorm, a 1x1x1 conv, a 5x5x5 depthwise
  conv and a 1x1x1 conv, then a 1x1x1-conv MLP behind a second BatchNorm);
  stages 3-4 are ``SABlock``s (global attention) or, with UNIFORMER.SPLIT,
  ``SplitSABlock``s (temporal, then spatial attention).
- Every block opens with the DPE, a stride-1 SAME 3x3x3 depthwise conv plus
  its bias: ``ops.depthwise3x3x3``, the hand-written kernel K1 on the card
  (its backward: dx through K1, dw through the wgrad kernel).
- 1x1x1 convs keep Conv3d weights [O, I, 1, 1, 1] and compute as a linear
  over the channel axis (``common.PointwiseConv``). The 5x5x5 depthwise conv
  has no kernel behind it in the JAX package; it is a grouped ``F.conv3d``
  on a contiguous NCDHW copy, which PyTorch runs with its own
  ``conv_depthwise3d_cuda_*`` kernels (not cuDNN) 6.3x faster than on the
  channels-last view (PERF.md, ``tools/pool_conv_variants.py
  --uniformer``).
- The attention is a plain qkv linear, matmul and softmax; the JAX package's
  ATTN_IMPL "per_head" is a TPU layout over the same parameters.
- The model has no rel-pos tables, so the portrait specialization is the
  same module on the transposed input: ``hw_switch`` is accepted and
  changes nothing. TPU.FOLD_STEM, a TPU layout of the stem conv, is not
  ported. There is no head dropout in the JAX package's model, so
  MODEL.DROPOUT_RATE is unused; UNIFORMER.DROPOUT_RATE and
  ATTENTION_DROPOUT_RATE > 0 are not ported for training.
- Eval returns the logits, as the JAX package's model does (no head
  activation).
- Under temporal sequence parallelism (TPU.SHARD_STRATEGY dp_sp,
  ``parallel/mesh.py``) a rank holds its T slice of every activation: the
  stage-1 patch embed (T kernel 3, stride 2) takes one halo plane on the
  left, the DPE convs one either side (K1 on T_loc + 2 planes,
  ``common.channels_last_conv3d``), the CBlocks' 5x5x5 conv two; stages 2-4
  embed with T kernel 1 (UNIFORMER.STD off) and need none. The attention
  keeps this rank's queries and gathers K and V over the model group
  (SplitSABlock's temporal branch per site), SplitSABlock's
  per-(clip, frame) DropPath masks are cut to the rank's planes, and the
  final mean sums over the model group (``mesh.t_mean``).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pmv_tpu_torch.models.batchnorm import BatchNorm
from pmv_tpu_torch.models.build import MODEL_REGISTRY
from pmv_tpu_torch.models.common import (
    ChannelsLastConv3d,
    DropPath,
    LayerNorm,
    Linear,
    Mlp,
    PointwiseConv,
)
from pmv_tpu_torch.models.mvit import geometry
from pmv_tpu_torch.parallel import mesh


class CMlp(nn.Module):
    """fc1 (1x1x1) -> tanh GELU -> fc2 (1x1x1) (`uniformer.py:100-116`)."""

    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = PointwiseConv(dim, hidden)
        self.fc2 = PointwiseConv(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Attention(nn.Module):
    """Multi-head self-attention on [B, N, C]. ``zero_init``: the
    temporal attention's init, qkv weights 0 and proj weights 1."""

    def __init__(self, dim, num_heads, qkv_bias=True, qk_scale=None, zero_init=False):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        if zero_init:
            self.qkv.init_value, self.proj.init_value = 0.0, 1.0

    def forward(self, x, gather=None):
        """``gather``: under sequence parallelism, a function that takes this
        rank's K and V rows [B, n, 2, heads, d] to the clip's; the queries
        stay this rank's."""
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, -1)
        kv = qkv[:, :, 1:] if gather is None else gather(qkv[:, :, 1:])
        q = qkv[:, :, 0].transpose(1, 2)
        k, v = kv.permute(2, 0, 3, 1, 4)
        attn = torch.matmul(q * self.scale, k.transpose(-2, -1)).softmax(dim=-1)
        return self.proj(torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c))


def _gather_tokens(kv, t):
    """[B, M t s, ...]: the K and V rows [B, t s, ...] of this rank's ``t``
    planes (s sites a plane, planes first), gathered over the model group in
    one collective (``mesh.gather_t``), in the clip's token order."""
    b = kv.shape[0]
    return mesh.gather_t(kv.reshape(b, t, -1, *kv.shape[2:])).flatten(1, 2)


def _gather_sites(kv, b, sites):
    """SplitSABlock's temporal K and V rows [B sites, t, ...] of this rank's
    ``t`` planes, gathered likewise: [B sites, M t, ...]."""
    grid = kv.unflatten(0, (b, sites)).transpose(1, 2)  # [B, t, sites, ...]
    return mesh.gather_t(grid).transpose(1, 2).flatten(0, 1)


class _Block(nn.Module):
    """What the three blocks share: the DPE, and one DropPath per residual
    branch, each drawing a keep mask over ``mask_rows`` rows per clip."""

    def __init__(self, dim, drop_path, mask_rows):
        super().__init__()
        self.pos_embed = ChannelsLastConv3d(dim, dim, 3, padding=1, groups=dim)
        self.drop_path_rate = drop_path
        self.mask_rows = mask_rows

    def sample_drop_path_masks(self, batch, generator, device=None):
        """Keep masks of the residual branches for one train-mode forward,
        or None when this block drops no path."""
        if self.drop_path_rate == 0.0:
            return None
        return tuple(DropPath(self.drop_path_rate).sample(batch * rows, generator, device)
                     for rows in self.mask_rows)


class CBlock(_Block):
    """Convolutional MHRA block (`uniformer.py:119-138`)."""

    def __init__(self, dim, mlp_ratio, drop_path):
        super().__init__(dim, drop_path, (1, 1))
        self.norm1 = BatchNorm(dim)
        self.conv1 = PointwiseConv(dim, dim)
        self.attn = ChannelsLastConv3d(dim, dim, 5, padding=2, groups=dim)
        self.conv2 = PointwiseConv(dim, dim)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = BatchNorm(dim)
        self.mlp = CMlp(dim, int(dim * mlp_ratio))
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x, masks=None):
        m1, m2 = masks or (None, None)
        x = x + self.pos_embed(x)
        x = x + self.drop_path1(self.conv2(self.attn(self.conv1(self.norm1(x)))), m1)
        return x + self.drop_path2(self.mlp(self.norm2(x)), m2)


class SABlock(_Block):
    """Global spatiotemporal attention block (`uniformer.py:141-165`)."""

    def __init__(self, dim, num_heads, mlp_ratio, qkv_bias, qk_scale, drop_path):
        super().__init__(dim, drop_path, (1, 1))
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x, masks=None):
        m1, m2 = masks or (None, None)
        x = x + self.pos_embed(x)
        tok = x.flatten(1, 3)
        t = x.shape[1]
        gather = None if mesh.active() is None else lambda kv: _gather_tokens(kv, t)
        tok = tok + self.drop_path1(self.attn(self.norm1(tok), gather), m1)
        tok = tok + self.drop_path2(self.mlp(self.norm2(tok)), m2)
        return tok.reshape(x.shape)


class SplitSABlock(_Block):
    """Temporal, then spatial attention (`uniformer.py:168-203`). As in the
    JAX package, the temporal branch drops paths per (clip, H x W site) and
    the spatial one per (clip, frame), on the block's input grid ``thw``."""

    def __init__(self, dim, num_heads, mlp_ratio, qkv_bias, qk_scale, drop_path, thw):
        t, h, w = thw
        super().__init__(dim, drop_path, (h * w, t, 1))
        self.t_norm = LayerNorm(dim)
        self.t_attn = Attention(dim, num_heads, qkv_bias, qk_scale, zero_init=True)
        self.drop_path_t = DropPath(drop_path)
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x, masks=None):
        mt, m1, m2 = masks or (None, None, None)
        x = x + self.pos_embed(x)
        b, t, h, w, c = x.shape
        lay = mesh.active()
        gather = None
        if lay is not None:
            # The temporal branch's keys span the clip's planes; the spatial
            # branch's masks, one per (clip, frame) of the clip, are cut to
            # this rank's frames.
            gather = lambda kv: _gather_sites(kv, b, h * w)  # noqa: E731
            if m1 is not None:
                start, stop = lay.planes(t * lay.model_size)
                m1 = m1.reshape(b, -1)[:, start:stop].reshape(-1)
        t_tok = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
        t_tok = t_tok + self.drop_path_t(self.t_attn(self.t_norm(t_tok), gather), mt)
        s_tok = t_tok.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4).reshape(b * t, h * w, c)
        s_tok = s_tok + self.drop_path1(self.attn(self.norm1(s_tok)), m1)
        tok = s_tok.reshape(b, t * h * w, c)
        tok = tok + self.drop_path2(self.mlp(self.norm2(tok)), m2)
        return tok.reshape(b, t, h, w, c)


class UniPatchEmbed(nn.Module):
    """Stage patch embed: a strided conv, then LayerNorm over the channels
    (`uniformer.py:206-260`). ``special``: the first stage's (3, n, n)
    kernel at stride (2, n, n); ``std``: (3, n, n) at stride (1, n, n);
    else (1, n, n) at stride (1, n, n)."""

    def __init__(self, dim_in, dim_out, patch_size, special=False, std=False):
        super().__init__()
        n = patch_size
        if special:
            kernel, stride, pad = (3, n, n), (2, n, n), (1, 0, 0)
        elif std:
            kernel, stride, pad = (3, n, n), (1, n, n), (1, 0, 0)
        else:
            kernel, stride, pad = (1, n, n), (1, n, n), (0, 0, 0)
        self.proj = ChannelsLastConv3d(dim_in, dim_out, kernel, stride, pad)
        self.norm = LayerNorm(dim_out)

    def out_grid(self, thw):
        p = self.proj
        return tuple((s + 2 * pd - k) // st + 1
                     for s, k, st, pd in zip(thw, p.kernel_size, p.stride, p.padding))

    def forward(self, x):
        return self.norm(self.proj(x))


class Uniformer(nn.Module):
    """Config-driven UniFormer. forward(x [B, T, H, W, 3]) -> logits, or the
    normed feature grid [B, T', H', W', C] with ``return_features``."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        u = cfg.UNIFORMER
        self.compute_dtype = dtype
        self.dropout_rates = (u.DROPOUT_RATE, u.ATTENTION_DROPOUT_RATE)
        depth, dims = list(u.DEPTH), list(u.EMBED_DIM)
        num_heads = [d // u.HEAD_DIM for d in dims]
        dpr = [float(r) for r in np.linspace(0, u.DROP_DEPTH_RATE, sum(depth))]
        pk = u.PATCH_KERNEL
        patch1 = pk if isinstance(pk, int) else (pk[0] if len(pk) else 4)

        # The train crop's grid at each stage: SplitSABlock's DropPath masks
        # are counted on it.
        thw = tuple(geometry(cfg))
        dim_in = 3
        first = 0
        for stage in range(4):
            embed = UniPatchEmbed(
                dim_in, dims[stage], patch1 if stage == 0 else 2,
                special=stage == 0 and not u.FRAME_BASE, std=stage > 0 and u.STD,
            )
            thw = embed.out_grid(thw)
            rates = dpr[first:first + depth[stage]]
            if stage < 2:
                blocks = [CBlock(dims[stage], u.MLP_RATIO, r) for r in rates]
            elif u.SPLIT:
                blocks = [SplitSABlock(dims[stage], num_heads[stage], u.MLP_RATIO,
                                       u.QKV_BIAS, u.QKV_SCALE, r, thw) for r in rates]
            else:
                blocks = [SABlock(dims[stage], num_heads[stage], u.MLP_RATIO,
                                  u.QKV_BIAS, u.QKV_SCALE, r) for r in rates]
            setattr(self, f"patch_embed{stage + 1}", embed)
            setattr(self, f"blocks{stage + 1}", nn.ModuleList(blocks))
            dim_in, first = dims[stage], first + depth[stage]
        self.norm = BatchNorm(dims[3])
        self.head = Linear(dims[3], cfg.MODEL.NUM_CLASSES)

    def _stages(self):
        return [(getattr(self, f"patch_embed{i}"), getattr(self, f"blocks{i}"))
                for i in range(1, 5)]

    def sample_drop_path_masks(self, batch, generator, device=None):
        """Per block, in order, the DropPath keep masks of one train-mode
        forward, drawn from ``generator``."""
        return [block.sample_drop_path_masks(batch, generator, device)
                for _, blocks in self._stages() for block in blocks]

    def sample_head_dropout_mask(self, batch, generator, device=None):
        """None: the JAX package's UniFormer head has no dropout."""
        return None

    def forward(self, x, return_features=False, drop_path_masks=None,
                head_dropout_mask=None, hw_switch=False):
        """``drop_path_masks`` (one entry per block, from
        ``sample_drop_path_masks``) in train mode when
        UNIFORMER.DROP_DEPTH_RATE > 0. ``head_dropout_mask`` and
        ``hw_switch`` change nothing (no head dropout, no rel-pos tables)."""
        if self.training and any(r > 0 for r in self.dropout_rates):
            raise NotImplementedError(
                "UNIFORMER.DROPOUT_RATE and ATTENTION_DROPOUT_RATE > 0 are not "
                "ported for training"
            )
        x = x.to(self.compute_dtype)
        masks = iter(drop_path_masks or [])
        for embed, blocks in self._stages():
            x = embed(x)
            for block in blocks:
                x = block(x, next(masks, None))
        x = self.norm(x)
        if return_features:
            return x
        return self.head(mesh.t_mean(x.flatten(1, 3), (1,)))


@MODEL_REGISTRY.register(name="Uniformer")
def build_uniformer(cfg, dtype=torch.float32):
    return Uniformer(cfg, dtype=dtype)


@MODEL_REGISTRY.register(name="Uniformerframe")
def build_uniformer_frame(cfg, dtype=torch.float32):
    """The frame-based variant (`uniformer_frame.py`): per-frame patch
    embeds, (1, n, n) at stride (1, n, n)."""
    if not cfg.UNIFORMER.FRAME_BASE:
        raise ValueError("Uniformerframe requires UNIFORMER.FRAME_BASE")
    return Uniformer(cfg, dtype=dtype)
