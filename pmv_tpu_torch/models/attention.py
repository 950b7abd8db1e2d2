"""MViT pooling attention with decomposed relative-position biases.

Counterpart of `pmv_tpu/models/attention.py`, written as the plain math
once. Tokens stay [B, N, heads, head_dim] from the qkv projection through
the pools (the JAX package's transpose-free layout), so every grid fold is
a reshape; the attention core is two ``torch.matmul``s around a broadcast add
of the decomposed rel-pos bias and a softmax.

Conv pools go through ``common.channels_last_conv3d``: the stride-1 3x3x3
ones to ``ops.depthwise3x3x3`` (the hand-written CUDA kernel on the card),
the strided ones to a grouped ``F.conv3d`` on a contiguous NCDHW copy, as
the JAX package leaves them to XLA.

Not ported, because they are exact TPU layout rewrites of the same math:
FusedQKVSplitDots (one ``qkv`` Linear here), SPARSE_KV_POOL (the full
projection followed by the strided conv), FLAT_POOLS / FlatGroupLN, the 0/1
rel-pos expansion matrix, q-chunked attention and the ``_DIAG_*`` switches.

MVIT.POOL_FIRST pools x itself, folded into the heads at the block's input
width, and runs the ``q``, ``k`` and ``v`` linears on the pooled tokens
(`attention.py:803-805, 865-875` of the JAX package); its stride-1 pools
run K1 at the input width.

Under temporal sequence parallelism (``parallel/mesh.py``) a rank holds
the token planes of its T slice and the cls token: its pools run on the
slice extended by their halo (``common.py``), then K's and V's tokens are
gathered over the model group in one collective, with one cls token, and
q stays local; the temporal rel-pos table takes the clip's q size and this
rank's q offset, since q_t is a slice of it.
"""

import functools

import numpy as np
import torch
from torch import nn

from pmv_tpu_torch.models.common import (
    Dropout,
    DropPath,
    LayerNorm,
    Linear,
    Mlp,
    avg_pool_3d,
    channels_last_conv3d,
    max_pool_3d,
)
from pmv_tpu_torch.parallel import mesh


@functools.lru_cache(maxsize=None)
def _linear_resize_weights(in_size, out_size):
    """[out, in] weights of ``jax.image.resize(..., "linear")`` along one axis.

    The JAX package resizes with JAX's scale-and-translate, which
    antialiases when downsampling (the triangle kernel widens by in/out); it
    agrees with ``F.interpolate(mode="linear")`` only when upsampling.
    ROADMAP.md records the difference from the reference under Faults.
    """
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    dist = np.abs(sample_f[None, :] - np.arange(in_size)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - dist)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, 1),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0.0).T.astype(np.float32)


def resize_axis(x, axis, size):
    """Linear resize of one axis of ``x`` to ``size``, as jax.image.resize."""
    if x.shape[axis] == size:
        return x
    w = torch.from_numpy(_linear_resize_weights(x.shape[axis], size))
    w = w.to(device=x.device, dtype=x.dtype)
    return torch.movedim(
        torch.tensordot(w, x, dims=([1], [axis])), 0, axis
    )


def interpolate_rel_pos(rel_pos, d):
    """Linear-resize a [L, C] rel-pos table to [d, C]."""
    return resize_axis(rel_pos, 0, d)


@functools.lru_cache(maxsize=None)
def _rel_index(q_size, k_size):
    """[q_size, k_size] row of the (2*max-1)-entry table for each q, k pair
    (`attention.py:67-159` of the reference)."""
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    dist = (
        np.arange(q_size)[:, None] * q_ratio - np.arange(k_size)[None, :] * k_ratio
    )
    dist += (k_size - 1) * k_ratio
    return dist.astype(np.int64)


def _rel_table(rel_pos, q_size, k_size):
    table = interpolate_rel_pos(rel_pos, int(2 * max(q_size, k_size) - 1))
    index = torch.from_numpy(_rel_index(q_size, k_size)).to(rel_pos.device)
    return table[index]  # [q_size, k_size, C]


def rel_q_tables_spatial(q, q_shape, k_shape, rel_pos_h, rel_pos_w, has_cls_embed):
    """Per-query-row spatial tables ([B, q_n, heads, k_h], [B, q_n, heads, k_w])
    for the token rows (cls excluded). q: [B, Nq, heads, C]."""
    sp = 1 if has_cls_embed else 0
    q_t, q_h, q_w = q_shape
    _, k_h, k_w = k_shape
    rh = _rel_table(rel_pos_h, q_h, k_h).to(q.dtype)
    rw = _rel_table(rel_pos_w, q_w, k_w).to(q.dtype)
    b, _, n_head, dim = q.shape
    r_q = q[:, sp:].reshape(b, q_t, q_h, q_w, n_head, dim)
    rel_h = torch.einsum("bthwyc,hkc->bthwyk", r_q, rh)
    rel_w = torch.einsum("bthwyc,wkc->bthwyk", r_q, rw)
    q_n = q_t * q_h * q_w
    return rel_h.reshape(b, q_n, n_head, k_h), rel_w.reshape(b, q_n, n_head, k_w)


def rel_q_table_temporal(q, q_shape, k_shape, rel_pos_t, has_cls_embed, q_t_total=None,
                         q_t_offset=0):
    """Per-query-row temporal table [B, q_n, heads, k_t]. With
    ``q_t_total``, q's ``q_shape[0]`` planes are planes [q_t_offset,
    q_t_offset + q_t) of the clip's ``q_t_total``: their rows of the clip's
    table."""
    sp = 1 if has_cls_embed else 0
    q_t, q_h, q_w = q_shape
    k_t = k_shape[0]
    rt = _rel_table(rel_pos_t, q_t_total or q_t, k_t)[q_t_offset:q_t_offset + q_t].to(q.dtype)
    b, _, n_head, dim = q.shape
    r_q = q[:, sp:].reshape(b, q_t, q_h, q_w, n_head, dim)
    rel = torch.einsum("bthwyc,tkc->bthwyk", r_q, rt)
    return rel.reshape(b, q_t * q_h * q_w, n_head, k_t)


class AttentionPool(nn.Module):
    """Pool the token grid of q, k or v; the cls token bypasses the pool.

    mode "conv": depthwise conv (one [head_dim] kernel shared by the heads,
    parameter ``weight`` [head_dim, 1, kt, kh, kw] as the reference's
    Conv3d), then the per-head LayerNorm passed in as ``norm`` (the reference
    registers it beside the pool, as ``norm_q`` / ``norm_k`` / ``norm_v``).
    "max" / "avg": pooling, no norm. Input and output [B, N, heads, C].
    """

    def __init__(self, kernel, stride, mode, has_cls_embed, head_dim):
        super().__init__()
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.mode = mode
        self.has_cls_embed = has_cls_embed
        self.identity = len(self.kernel) == 0 or (
            np.prod(self.kernel) == 1 and np.prod(self.stride) == 1
        )
        if mode not in ("conv", "max", "avg"):
            raise NotImplementedError(f"Unsupported pool mode {mode}")
        if mode == "conv" and not self.identity:
            self.weight = nn.Parameter(torch.empty(head_dim, 1, *self.kernel))

    def out_grid(self, thw):
        """The (T, H, W) grid this pool gives on a grid ``thw``."""
        if self.identity:
            return tuple(thw)
        return tuple((s + 2 * (k // 2) - k) // st + 1
                     for s, k, st in zip(thw, self.kernel, self.stride))

    def forward(self, x, thw_shape, norm=None):
        if self.identity:
            return x, tuple(thw_shape)
        b, _, heads, c = x.shape
        if self.has_cls_embed:
            cls_tok, x = x[:, :1], x[:, 1:]
        # Heads fold into channels h-major (folded channel j = h*C + c), so
        # the shared per-head kernel tiles H times along channels.
        grid = x.reshape(b, *thw_shape, heads * c)
        padding = [k // 2 for k in self.kernel]
        if self.mode == "conv":
            grid = channels_last_conv3d(grid, self.weight.repeat(heads, 1, 1, 1, 1), None,
                                        self.stride, padding, groups=heads * c)
        elif self.mode == "max":
            grid = max_pool_3d(grid, self.kernel, self.stride, padding)
        else:
            grid = avg_pool_3d(grid, self.kernel, self.stride, padding)
        new_thw = tuple(grid.shape[1:4])
        x = grid.reshape(b, -1, heads, c)
        if self.has_cls_embed:
            x = torch.cat([cls_tok, x], dim=1)
        if norm is not None:
            x = norm(x)
        return x, new_thw


def gather_kv(k, v, thw_shape, has_cls_embed):
    """K's and V's tokens ([B, N, heads, C], this rank's T slice of the grid
    ``thw_shape`` after a cls token where ``has_cls_embed``) gathered over
    the model group in one collective, this rank's cls token first: (k, v,
    the clip's grid)."""
    sp = 1 if has_cls_embed else 0
    b, _, heads, c = k.shape
    t = thw_shape[0]
    kv = torch.cat([k[:, sp:], v[:, sp:]], dim=-1).reshape(b, t, -1, heads, 2 * c)
    kv = mesh.gather_t(kv).flatten(1, 2)
    k_tok, v_tok = kv[..., :c], kv[..., c:]
    if has_cls_embed:
        k_tok, v_tok = torch.cat([k[:, :1], k_tok], dim=1), torch.cat([v[:, :1], v_tok], dim=1)
    return k_tok, v_tok, (kv.shape[1] // (thw_shape[1] * thw_shape[2]), *thw_shape[1:])


class MultiScaleAttention(nn.Module):
    """Pooling attention (`attention.py:166-461` of the reference)."""

    def __init__(
        self,
        dim,
        dim_out,
        input_size,
        num_heads=1,
        qkv_bias=False,
        drop_rate=0.0,
        kernel_q=(),
        kernel_kv=(),
        stride_q=(),
        stride_kv=(),
        has_cls_embed=True,
        mode="conv",
        pool_first=False,
        rel_pos_spatial=False,
        rel_pos_temporal=False,
        rel_pos_zero_init=False,
        residual_pooling=False,
        separate_qkv=False,
        hw_switch=False,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.dim_out = dim_out
        head_dim = dim_out // num_heads
        self.scale = head_dim ** -0.5
        self.has_cls_embed = has_cls_embed
        self.residual_pooling = residual_pooling
        self.separate_qkv = separate_qkv
        # POOL_FIRST: x itself, folded into the heads at dim, is pooled, and
        # the q, k and v linears act on the pooled tokens.
        self.pool_first = pool_first
        # hw_switch (the reference's switch-auto): on a portrait grid
        # (H > W) the H axis uses the W table and vice versa.
        self.hw_switch = hw_switch
        self.rel_pos_spatial = rel_pos_spatial
        self.rel_pos_temporal = rel_pos_temporal
        self.rel_pos_zero_init = rel_pos_zero_init

        if separate_qkv or pool_first:
            self.q = Linear(dim, dim_out, bias=qkv_bias)
            self.k = Linear(dim, dim_out, bias=qkv_bias)
            self.v = Linear(dim, dim_out, bias=qkv_bias)
        else:
            self.qkv = Linear(dim, dim_out * 3, bias=qkv_bias)
        self.proj = Linear(dim_out, dim_out)
        self.proj_drop = Dropout(drop_rate)

        pool_dim = dim // num_heads if pool_first else head_dim
        for name, kernel, stride in (
            ("q", kernel_q, stride_q),
            ("k", kernel_kv, stride_kv),
            ("v", kernel_kv, stride_kv),
        ):
            pool = AttentionPool(kernel, stride, mode, has_cls_embed, pool_dim)
            setattr(self, f"pool_{name}", pool)
            norm = (
                LayerNorm(pool_dim)
                if mode == "conv" and not pool.identity
                else None
            )
            setattr(self, f"norm_{name}", norm)

        if rel_pos_spatial:
            sq = stride_q[1:] if stride_q else (1, 1)
            skv = stride_kv[1:] if stride_kv else (1, 1)
            size_h = 2 * max(input_size[1] // sq[0], input_size[1] // skv[0]) - 1
            size_w = 2 * max(input_size[2] // sq[1], input_size[2] // skv[1]) - 1
            self.rel_pos_h = nn.Parameter(torch.zeros(size_h, head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(size_w, head_dim))
        if rel_pos_temporal:
            self.rel_pos_t = nn.Parameter(
                torch.zeros(2 * input_size[0] - 1, head_dim)
            )

    def forward(self, x, thw_shape, hw_switch=False, proj_mask=None):
        """``hw_switch`` sets the table swap for this call, on top of the
        module's own (the portrait specialization shares the parameters).
        ``proj_mask``: the projection's dropout keep mask [B, N_q, dim_out]
        of the clip, in training at a rate above 0."""
        b, n, _ = x.shape
        heads = self.num_heads
        if self.pool_first:
            q = k = v = x.reshape(b, n, heads, -1)
        elif self.separate_qkv:
            q, k, v = (
                proj(x).reshape(b, n, heads, -1)
                for proj in (self.q, self.k, self.v)
            )
        else:
            q, k, v = self.qkv(x).reshape(b, n, 3, heads, -1).unbind(2)

        q, q_shape = self.pool_q(q, thw_shape, self.norm_q)
        k, k_shape = self.pool_k(k, thw_shape, self.norm_k)
        v, _ = self.pool_v(v, thw_shape, self.norm_v)
        if self.pool_first:
            q, k, v = (proj(t.flatten(2)).unflatten(2, (heads, -1))
                       for proj, t in ((self.q, q), (self.k, k), (self.v, v)))
        q_t_total, q_t_offset = q_shape[0], 0
        lay = mesh.active()
        if lay is not None:
            k, v, k_shape = gather_kv(k, v, k_shape, self.has_cls_embed)
            q_t_total, q_t_offset = q_shape[0] * lay.model_size, q_shape[0] * lay.model

        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, N, C]
        attn = torch.matmul(qh * self.scale, kh.transpose(-2, -1))
        if self.rel_pos_spatial or self.rel_pos_temporal:
            sp = 1 if self.has_cls_embed else 0
            # Bias of the token rows and columns; the cls row and column get
            # none. Key column index = (t * k_h + h) * k_w + w.
            bias = attn[:, :, sp:, sp:].unflatten(-1, tuple(k_shape))
            if self.rel_pos_spatial:
                rp_h, rp_w = self.rel_pos_h, self.rel_pos_w
                if (self.hw_switch or hw_switch) and thw_shape[1] > thw_shape[2]:
                    rp_h, rp_w = rp_w, rp_h
                rel_h, rel_w = rel_q_tables_spatial(
                    q, q_shape, k_shape, rp_h, rp_w, self.has_cls_embed
                )
                bias += rel_h.transpose(1, 2)[:, :, :, None, :, None]
                bias += rel_w.transpose(1, 2)[:, :, :, None, None, :]
            if self.rel_pos_temporal:
                rel_t = rel_q_table_temporal(
                    q, q_shape, k_shape, self.rel_pos_t, self.has_cls_embed,
                    q_t_total, q_t_offset,
                )
                bias += rel_t.transpose(1, 2)[:, :, :, :, None, None]
        attn = attn.softmax(dim=-1)
        x = torch.matmul(attn, vh).transpose(1, 2)  # [B, Nq, H, C]

        if self.residual_pooling:
            if self.has_cls_embed:
                x = torch.cat([x[:, :1], x[:, 1:] + q[:, 1:]], dim=1)
            else:
                x = x + q

        proj_mask = mesh.local_planes(proj_mask, 1, q_shape[1] * q_shape[2],
                                      1 if self.has_cls_embed else 0)
        x = self.proj_drop(self.proj(x.reshape(b, -1, self.dim_out)), proj_mask)
        return x, q_shape


class MultiScaleBlock(nn.Module):
    """Transformer block with pooling attention (`attention.py:464-589`)."""

    def __init__(
        self,
        dim,
        dim_out,
        num_heads,
        input_size,
        mlp_ratio=4.0,
        qkv_bias=False,
        drop_rate=0.0,
        drop_path=0.0,
        layer_scale_init_value=0.0,
        kernel_q=(),
        kernel_kv=(),
        stride_q=(),
        stride_kv=(),
        mode="conv",
        has_cls_embed=True,
        pool_first=False,
        rel_pos_spatial=False,
        rel_pos_temporal=False,
        rel_pos_zero_init=False,
        residual_pooling=False,
        dim_mul_in_att=False,
        separate_qkv=False,
        hw_switch=False,
    ):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.dim_mul_in_att = dim_mul_in_att
        self.has_cls_embed = has_cls_embed
        att_dim = dim_out if dim_mul_in_att else dim
        self.norm1 = LayerNorm(dim)
        self.attn = MultiScaleAttention(
            dim, att_dim, input_size, num_heads=num_heads, qkv_bias=qkv_bias,
            drop_rate=drop_rate, kernel_q=kernel_q, kernel_kv=kernel_kv,
            stride_q=stride_q, stride_kv=stride_kv,
            has_cls_embed=has_cls_embed, mode=mode, pool_first=pool_first,
            rel_pos_spatial=rel_pos_spatial, rel_pos_temporal=rel_pos_temporal,
            rel_pos_zero_init=rel_pos_zero_init,
            residual_pooling=residual_pooling, separate_qkv=separate_qkv,
            hw_switch=hw_switch,
        )
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)
        self.norm2 = LayerNorm(att_dim)
        self.mlp = Mlp(att_dim, int(att_dim * mlp_ratio), dim_out, drop_rate)
        if dim != dim_out:
            self.proj = Linear(dim, dim_out)
        if layer_scale_init_value > 0:
            self.gamma_1 = nn.Parameter(
                torch.full((att_dim,), float(layer_scale_init_value))
            )
            self.gamma_2 = nn.Parameter(
                torch.full((dim_out,), float(layer_scale_init_value))
            )
        else:
            self.gamma_1 = self.gamma_2 = None
        # Skip-path max pool when q is strided, kernel stride + 1.
        self.stride_skip = tuple(stride_q)
        self.pool_skip = len(stride_q) > 0 and np.prod(stride_q) > 1
        self.kernel_skip = tuple(s + 1 if s > 1 else s for s in stride_q)

    def sample_drop_path_masks(self, batch, generator, device=None):
        """Keep masks (attention branch, MLP branch) for one train-mode
        forward, or None when this block drops no path."""
        if self.drop_path1.rate == 0.0:
            return None
        return (
            self.drop_path1.sample(batch, generator, device),
            self.drop_path2.sample(batch, generator, device),
        )

    def sample_dropout_masks(self, batch, thw, generator, device=None):
        """(the grid after this block, the keep masks of its dropouts for one
        train-mode forward on ``batch`` clips of the grid ``thw``: the
        attention projection's [B, N_q, att_dim], then the MLP's two) or
        (grid, None) when MVIT.DROPOUT_RATE is 0."""
        thw = self.attn.pool_q.out_grid(thw)
        rows = (batch, int(np.prod(thw)) + (1 if self.has_cls_embed else 0))
        if self.attn.proj_drop.rate == 0.0:
            return thw, None
        return thw, (self.attn.proj_drop.sample((*rows, self.attn.dim_out), generator, device),
                     *self.mlp.sample_dropout_masks(rows, generator, device))

    def forward(self, x, thw_shape, drop_path_masks=None, hw_switch=False,
                dropout_masks=None):
        mask1, mask2 = drop_path_masks or (None, None)
        proj_mask, *mlp_masks = dropout_masks or (None, None, None)
        x_norm = self.norm1(x)
        x_block, thw_shape_new = self.attn(x_norm, thw_shape, hw_switch, proj_mask)
        if self.dim_mul_in_att and self.dim != self.dim_out:
            x = self.proj(x_norm)
        if self.pool_skip:
            b, _, c = x.shape
            cls_tok, toks = (x[:, :1], x[:, 1:]) if self.has_cls_embed else (None, x)
            toks = max_pool_3d(
                toks.reshape(b, *thw_shape, c), self.kernel_skip,
                self.stride_skip, [k // 2 for k in self.kernel_skip],
            ).reshape(b, -1, c)
            x = toks if cls_tok is None else torch.cat([cls_tok, toks], dim=1)
        if self.gamma_1 is not None:
            x_block = self.gamma_1.to(x_block.dtype) * x_block
        x = x + self.drop_path1(x_block, mask1)
        x_norm = self.norm2(x)
        plane, cls = thw_shape_new[1] * thw_shape_new[2], 1 if self.has_cls_embed else 0
        x_mlp = self.mlp(x_norm, [mesh.local_planes(m, 1, plane, cls) for m in mlp_masks])
        if not self.dim_mul_in_att and self.dim != self.dim_out:
            x = self.proj(x_norm)
        if self.gamma_2 is not None:
            x_mlp = self.gamma_2.to(x_mlp.dtype) * x_mlp
        x = x + self.drop_path2(x_mlp, mask2)
        return x, thw_shape_new
