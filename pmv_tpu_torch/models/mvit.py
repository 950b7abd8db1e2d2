"""MViT v1/v2 (`MViT/slowfast/models/video_model_builder.py:1726-2171`).

Counterpart of `pmv_tpu/models/mvit.py`. Input is channels-last
[B, T, H, W, C]. Parameter shapes are fixed at construction from the crop
geometry of ``geometry``; any other grid runs the same parameters, with
rel-pos tables resized to the runtime grid. On a grid with H > W the H and
W tables swap when the switch is on: DATA.TRAIN_CROP_SIZE_RECT_SWITCH_AUTO,
or ``forward(..., hw_switch=True)``, which is how the portrait
specialization of the JAX package (``build_model(cfg, hw_switch=True)``, a
second module over the same parameters) is one module here.

Inside ``parallel.mesh.sequence_parallel`` (TPU.SHARD_STRATEGY dp_sp) the
input is a rank's frames of the clip, and every activation its token
planes: the cls token is replicated on every rank of the model group, the
fixed and absolute position embeddings are sliced at the rank's T offset,
and the mean pooling sums over the model group.

In a train-mode forward with grad enabled, a block recomputes its
activations in the backward (``torch.utils.checkpoint``, non-reentrant),
as the JAX package remats it: every block under MODEL.ACT_CHECKPOINT, and
under TPU.REMAT_MIN_SEQ those whose input grid holds at least that many
tokens (``MViT.remats``).
"""

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pmv_tpu_torch.models.attention import MultiScaleBlock, resize_axis
from pmv_tpu_torch.models.build import MODEL_REGISTRY
from pmv_tpu_torch.models.common import Dropout, LayerNorm, round_width
from pmv_tpu_torch.models.heads import TransformerBasicHead
from pmv_tpu_torch.models.stem import PatchEmbed
from pmv_tpu_torch.parallel import mesh


def _compute_mvit_schedule(cfg):
    """Per-block (dim, dim_out, heads, pool kernels/strides).

    Mirrors the constructor schedule logic at
    `video_model_builder.py:1860-1960` including POOL_KV_STRIDE_ADAPTIVE.
    """
    depth = cfg.MVIT.DEPTH
    embed_dim = cfg.MVIT.EMBED_DIM
    num_heads = cfg.MVIT.NUM_HEADS

    dim_mul = np.ones(depth + 1)
    head_mul = np.ones(depth + 1)
    for i in range(len(cfg.MVIT.DIM_MUL)):
        dim_mul[cfg.MVIT.DIM_MUL[i][0]] = cfg.MVIT.DIM_MUL[i][1]
    for i in range(len(cfg.MVIT.HEAD_MUL)):
        head_mul[cfg.MVIT.HEAD_MUL[i][0]] = cfg.MVIT.HEAD_MUL[i][1]

    pool_q = [[] for _ in range(depth)]
    pool_kv = [[] for _ in range(depth)]
    stride_q = [[] for _ in range(depth)]
    stride_kv = [[] for _ in range(depth)]

    for i in range(len(cfg.MVIT.POOL_Q_STRIDE)):
        stride_q[cfg.MVIT.POOL_Q_STRIDE[i][0]] = cfg.MVIT.POOL_Q_STRIDE[i][1:]
        if cfg.MVIT.POOL_KVQ_KERNEL is not None:
            pool_q[cfg.MVIT.POOL_Q_STRIDE[i][0]] = cfg.MVIT.POOL_KVQ_KERNEL
        else:
            pool_q[cfg.MVIT.POOL_Q_STRIDE[i][0]] = [
                s + 1 if s > 1 else s for s in cfg.MVIT.POOL_Q_STRIDE[i][1:]
            ]

    pool_kv_stride = list(cfg.MVIT.POOL_KV_STRIDE)
    if cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE is not None:
        _stride_kv = list(cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE)
        pool_kv_stride = []
        for i in range(depth):
            if len(stride_q[i]) > 0:
                _stride_kv = [
                    max(_stride_kv[d] // stride_q[i][d], 1)
                    for d in range(len(_stride_kv))
                ]
            pool_kv_stride.append([i] + _stride_kv)

    for i in range(len(pool_kv_stride)):
        stride_kv[pool_kv_stride[i][0]] = pool_kv_stride[i][1:]
        if cfg.MVIT.POOL_KVQ_KERNEL is not None:
            pool_kv[pool_kv_stride[i][0]] = cfg.MVIT.POOL_KVQ_KERNEL
        else:
            pool_kv[pool_kv_stride[i][0]] = [
                s + 1 if s > 1 else s for s in pool_kv_stride[i][1:]
            ]

    blocks = []
    for i in range(depth):
        num_heads = round_width(num_heads, head_mul[i])
        if cfg.MVIT.DIM_MUL_IN_ATT:
            dim_out = round_width(
                embed_dim, dim_mul[i],
                divisor=round_width(num_heads, head_mul[i]),
            )
        else:
            dim_out = round_width(
                embed_dim, dim_mul[i + 1],
                divisor=round_width(num_heads, head_mul[i + 1]),
            )
        blocks.append(
            dict(
                dim=embed_dim,
                dim_out=dim_out,
                num_heads=num_heads,
                kernel_q=tuple(pool_q[i]),
                kernel_kv=tuple(pool_kv[i]),
                stride_q=tuple(stride_q[i]),
                stride_kv=tuple(stride_kv[i]),
            )
        )
        embed_dim = dim_out
    return blocks


def get_3d_sincos_pos_embed(embed_dim, grid_size, t_size, cls_token=False):
    """Fixed 3D sin-cos position embedding (`utils.py` in the reference)."""
    assert embed_dim % 4 == 0
    embed_dim_spatial = embed_dim // 4 * 3
    embed_dim_temporal = embed_dim // 4

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])
    pos_embed_spatial = _sincos_2d(embed_dim_spatial, grid)

    grid_t = np.arange(t_size, dtype=np.float32)
    pos_embed_temporal = _sincos_1d(embed_dim_temporal, grid_t)

    pos_embed_temporal = np.repeat(
        pos_embed_temporal[:, None, :], grid_size ** 2, axis=1
    )
    pos_embed_spatial = np.repeat(
        pos_embed_spatial[None, :, :], t_size, axis=0
    )
    pos_embed = np.concatenate([pos_embed_temporal, pos_embed_spatial], axis=-1)
    pos_embed = pos_embed.reshape(-1, embed_dim)
    if cls_token:
        pos_embed = np.concatenate([np.zeros([1, embed_dim]), pos_embed], axis=0)
    return pos_embed


def _sincos_2d(embed_dim, grid):
    emb_h = _sincos_1d(embed_dim // 2, grid[0].reshape(-1))
    emb_w = _sincos_1d(embed_dim // 2, grid[1].reshape(-1))
    return np.concatenate([emb_h, emb_w], axis=1)


def _sincos_1d(embed_dim, pos):
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def geometry(cfg):
    """(T, H, W) of the input clip the parameter shapes are built for."""
    if cfg.TEST.PROCESS:
        rect, square = cfg.DATA.TEST_CROP_SIZE_RECT, cfg.DATA.TEST_CROP_SIZE
    else:
        rect, square = cfg.DATA.TRAIN_CROP_SIZE_RECT, cfg.DATA.TRAIN_CROP_SIZE
    spatial = list(rect) if len(rect) != 0 else [square, square]
    return [cfg.DATA.NUM_FRAMES, spatial[0], spatial[1]]


class MViT(nn.Module):
    """Config-driven MViT. forward(x [B, T, H, W, 3]) -> class scores
    (softmax'd at eval, logits in train mode), or (tokens, thw) with
    ``return_features``: the last block's tokens, before the final norm.
    With ``head=False`` the model has no final norm and no head, and only
    returns features: the backbone of MaskMViT, whose JAX counterpart never
    calls them and so has no parameters for them."""

    def __init__(self, cfg, dtype=torch.float32, head=True):
        super().__init__()
        self.compute_dtype = dtype
        self.cls_on = cfg.MVIT.CLS_EMBED_ON
        self.act_checkpoint = cfg.MODEL.ACT_CHECKPOINT
        self.remat_min_seq = cfg.TPU.REMAT_MIN_SEQ
        self.use_mean_pooling = cfg.MVIT.USE_MEAN_POOLING
        input_dims = geometry(cfg)
        patch_stride = list(cfg.MVIT.PATCH_STRIDE)
        if cfg.MVIT.PATCH_2D:
            patch_stride = [1] + patch_stride
        self.patch_dims = [input_dims[i] // patch_stride[i] for i in range(3)]
        num_patches = int(np.prod(self.patch_dims))
        embed_dim = cfg.MVIT.EMBED_DIM
        s = 1 if self.cls_on else 0

        self.patch_embed = PatchEmbed(
            3, embed_dim, cfg.MVIT.PATCH_KERNEL, cfg.MVIT.PATCH_STRIDE,
            cfg.MVIT.PATCH_PADDING, conv_2d=cfg.MVIT.PATCH_2D,
        )
        if cfg.MVIT.USE_FIXED_SINCOS_POS:
            sincos = get_3d_sincos_pos_embed(
                embed_dim, self.patch_dims[1], self.patch_dims[0],
                cls_token=self.cls_on,
            )
            self.register_buffer(
                "pos_fixed",
                torch.tensor(sincos, dtype=torch.float32)[None],
                persistent=False,
            )
        else:
            self.pos_fixed = None
        if self.cls_on:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.use_abs_pos = cfg.MVIT.USE_ABS_POS
        self.sep_pos_embed = cfg.MVIT.SEP_POS_EMBED
        if self.use_abs_pos:
            pt, ph, pw = self.patch_dims
            if self.sep_pos_embed:
                self.pos_embed_spatial = nn.Parameter(torch.zeros(1, ph * pw, embed_dim))
                self.pos_embed_temporal = nn.Parameter(torch.zeros(1, pt, embed_dim))
                if self.cls_on:
                    self.pos_embed_class = nn.Parameter(torch.zeros(1, 1, embed_dim))
            else:
                self.pos_embed = nn.Parameter(
                    torch.zeros(1, num_patches + s, embed_dim)
                )
        self.pos_drop = Dropout(cfg.MVIT.DROPOUT_RATE)
        self.norm_stem = LayerNorm(embed_dim) if cfg.MVIT.NORM_STEM else None

        depth = cfg.MVIT.DEPTH
        dpr = [float(r) for r in np.linspace(0, cfg.MVIT.DROPPATH_RATE, depth)]
        input_size = list(self.patch_dims)
        blocks = []
        for i, spec in enumerate(_compute_mvit_schedule(cfg)):
            blocks.append(MultiScaleBlock(
                dim=spec["dim"],
                dim_out=spec["dim_out"],
                num_heads=spec["num_heads"],
                input_size=tuple(input_size),
                mlp_ratio=cfg.MVIT.MLP_RATIO,
                qkv_bias=cfg.MVIT.QKV_BIAS,
                drop_rate=cfg.MVIT.DROPOUT_RATE,
                drop_path=dpr[i],
                layer_scale_init_value=cfg.MVIT.LAYER_SCALE_INIT_VALUE,
                kernel_q=spec["kernel_q"],
                kernel_kv=spec["kernel_kv"],
                stride_q=spec["stride_q"],
                stride_kv=spec["stride_kv"],
                mode=cfg.MVIT.MODE,
                has_cls_embed=self.cls_on,
                pool_first=cfg.MVIT.POOL_FIRST,
                rel_pos_spatial=cfg.MVIT.REL_POS_SPATIAL,
                rel_pos_temporal=cfg.MVIT.REL_POS_TEMPORAL,
                rel_pos_zero_init=cfg.MVIT.REL_POS_ZERO_INIT,
                residual_pooling=cfg.MVIT.RESIDUAL_POOLING,
                dim_mul_in_att=cfg.MVIT.DIM_MUL_IN_ATT,
                separate_qkv=cfg.MVIT.SEPARATE_QKV,
                hw_switch=cfg.DATA.TRAIN_CROP_SIZE_RECT_SWITCH_AUTO,
            ))
            embed_dim = spec["dim_out"]
            if len(spec["stride_q"]) > 0:
                input_size = [
                    size // stride
                    for size, stride in zip(input_size, spec["stride_q"])
                ]
        self.blocks = nn.ModuleList(blocks)
        self.dim_out = embed_dim
        self.features = nn.Identity()  # the Grad-CAM tap (visualization/gradcam.py)
        if head:
            self.norm = LayerNorm(embed_dim)
            self.head = TransformerBasicHead(
                embed_dim, cfg.MODEL.NUM_CLASSES,
                dropout_rate=cfg.MODEL.DROPOUT_RATE, act_func=cfg.MODEL.HEAD_ACT,
                detach_final_fc=cfg.MODEL.DETACH_FINAL_FC,
            )

    def _abs_pos_embed(self, thw):
        if self.sep_pos_embed:
            pt, ph, pw = self.patch_dims
            pos = self.pos_embed_spatial.repeat(1, pt, 1) + torch.repeat_interleave(
                self.pos_embed_temporal, ph * pw, dim=1
            )
            if self.cls_on:
                pos = torch.cat([self.pos_embed_class, pos], dim=1)
        else:
            pos = self.pos_embed
        if tuple(self.patch_dims) == tuple(thw):
            return pos
        # Trilinear resize to the runtime grid (`_get_pos_embed`, :2051-2073),
        # by the JAX package's jax.image.resize weights.
        if self.cls_on:
            cls_pos, pos = pos[:, :1], pos[:, 1:]
        grid = pos.reshape(1, *self.patch_dims, pos.shape[-1])
        for axis, size in zip((1, 2, 3), thw):
            grid = resize_axis(grid, axis, size)
        pos = grid.reshape(1, -1, grid.shape[-1])
        if self.cls_on:
            pos = torch.cat([cls_pos, pos], dim=1)
        return pos

    def sample_drop_path_masks(self, batch, generator, device=None):
        """Per block, the DropPath keep masks of one train-mode forward
        (``MultiScaleBlock.sample_drop_path_masks``), drawn from
        ``generator``."""
        return [
            block.sample_drop_path_masks(batch, generator, device)
            for block in self.blocks
        ]

    def sample_head_dropout_mask(self, batch, generator, device=None):
        """The head's dropout keep mask [batch, dim] for one train-mode
        forward, or None when MODEL.DROPOUT_RATE is 0."""
        return self.head.dropout.sample((batch, self.head.dim_in), generator, device)

    def sample_dropout_masks(self, shape, generator, device=None):
        """The keep masks of MVIT.DROPOUT_RATE's dropouts for one train-mode
        forward on clips of ``shape`` ([B, T, H, W, C]; the whole clip under
        sequence parallelism, whose forward takes its rank's planes of
        them), in the JAX package's order: the embedding's [B, N, D], then
        per block ``MultiScaleBlock.sample_dropout_masks``; None at rate 0."""
        if self.pos_drop.rate == 0.0:
            return None
        thw = self.patch_embed.out_grid(shape[1:4])
        rows = (shape[0], int(np.prod(thw)) + (1 if self.cls_on else 0))
        masks = [self.pos_drop.sample((*rows, self.patch_embed.proj.out_channels), generator,
                                      device)]
        for block in self.blocks:
            thw, block_masks = block.sample_dropout_masks(shape[0], thw, generator, device)
            masks.append(block_masks)
        return masks

    def remats(self, thw):
        """Whether a block whose input is on the token grid ``thw`` (a rank's
        inside ``mesh.sequence_parallel``) recomputes its activations in a
        train step's backward: under MODEL.ACT_CHECKPOINT, or where the
        clip's tokens, T x H x W without the cls token, reach
        TPU.REMAT_MIN_SEQ (> 0). The count is the clip's, not the rank's,
        as the JAX package decides on the global grid."""
        if self.act_checkpoint:
            return True
        return 0 < self.remat_min_seq <= int(np.prod(mesh.clip_grid(thw)))

    def forward(self, x, return_features=False, drop_path_masks=None,
                head_dropout_mask=None, hw_switch=False, dropout_masks=None):
        """In train mode, ``drop_path_masks`` (one entry per block, from
        ``sample_drop_path_masks``) when MVIT.DROPPATH_RATE > 0,
        ``head_dropout_mask`` (``sample_head_dropout_mask``) when
        MODEL.DROPOUT_RATE > 0, and ``dropout_masks``
        (``sample_dropout_masks``) when MVIT.DROPOUT_RATE > 0.
        ``hw_switch`` runs the portrait specialization: the rel-pos H and W
        tables swap on grids with H > W."""
        lay = mesh.active()
        x, thw = self.patch_embed(x.to(self.compute_dtype))
        b, _, c = x.shape
        s = 1 if self.cls_on else 0
        plane = thw[1] * thw[2]  # a clip's tables cut to this rank's planes
        if self.pos_fixed is not None:
            x = x + mesh.local_planes(self.pos_fixed[:, s:], 1, plane).to(x.dtype)
        if self.cls_on:
            cls_tokens = self.cls_token.to(x.dtype).expand(b, -1, -1)
            if self.pos_fixed is not None:
                cls_tokens = cls_tokens + self.pos_fixed[:, :s].to(x.dtype)
            x = torch.cat([cls_tokens, x], dim=1)
        if self.use_abs_pos:
            x = x + mesh.local_planes(self._abs_pos_embed(mesh.clip_grid(thw)), 1, plane,
                                      s).to(x.dtype)
        pos_mask, *dropouts = dropout_masks or [None] * (len(self.blocks) + 1)
        x = self.pos_drop(x, mesh.local_planes(pos_mask, 1, plane, s))
        if self.norm_stem is not None:
            x = self.norm_stem(x)

        masks = drop_path_masks or [None] * len(self.blocks)
        recompute = self.training and torch.is_grad_enabled()
        for block, block_masks, block_dropouts in zip(self.blocks, masks, dropouts):
            args = (x, thw, block_masks, hw_switch, block_dropouts)
            if recompute and self.remats(thw):
                # The recompute draws nothing (the DropPath and dropout keep
                # masks come in as arguments), so it needs no RNG state; it
                # runs K1's forward again, and the block's T collectives
                # under dp_sp, in the same order on every rank of a model
                # group. It runs in the backward, outside the step's
                # mesh.sequence_parallel: _block_in re-enters the layout.
                x, thw = checkpoint(_block_in, lay, block, *args, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, thw = block(*args)
        x = self.features(x)
        if return_features:
            return x, thw

        if self.use_mean_pooling:
            if self.cls_on:
                x = x[:, 1:]
            x = self.norm(mesh.t_mean(x, (1,)))
        elif self.cls_on:
            x = self.norm(x)[:, 0]
        else:
            x = mesh.t_mean(self.norm(x), (1,))
        return self.head(x, head_dropout_mask)


def _block_in(lay, block, *args):
    """``block(*args)`` inside the sequence parallelism of ``lay`` (None:
    outside it)."""
    with mesh.sequence_parallel(lay):
        return block(*args)


@MODEL_REGISTRY.register(name="MViT")
def build_mvit(cfg, dtype=torch.float32):
    return MViT(cfg, dtype=dtype)
