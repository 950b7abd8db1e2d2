"""Masked video pre-training: MaskMViT (MaskFeat), `MViT/slowfast/models/masked.py`.

Counterpart of `pmv_tpu/models/masked.py`, with its design: the masked
patches' input pixels are replaced by a learned mask token (the JAX
package's pixel-level substitution, `masked.py:133-147`; the reference
substitutes patch tokens), the MViT backbone runs the whole token grid, its
last tokens are brought back to the patch grid by nearest up-sampling where
the backbone pooled them, an optional decoder of ``MultiScaleBlock``s runs
over that grid, and a separate head regresses the targets: HOG descriptors
of each patch (MASK.PRED_HOG, computed on the device), or its pixels (MAE;
MASK.TIME_STRIDE_LOSS, MASK.NORM_PRED_PIXEL).

Random draws are split as the port splits every draw: ``sample_mask``
draws the model's own mask, exactly ``int(n_tok * (AUG.MASK_RATIO or
0.4))`` tokens a row, each token equally likely (the JAX package's
``scores < sort(scores)[k]`` over uniform scores, from its "mask" RNG
stream); the forward takes a mask, the model's or the loader's
(AUG.GEN_MASK_LOADER); the backbone's MVIT.DROPOUT_RATE keep masks come in
as ``dropout_masks`` (``sample_dropout_masks``). A mask whose token count
is not the patch grid's raises a ``ValueError`` naming both (the JAX
package fails there on a bare reshape: the published PT yaml's
AUG.MASK_WINDOW_SIZE [8, 7, 7] against a patch grid of 8 x 56 x 56).

The backbone recomputes its blocks in the backward as ``MViT.remats``
says (MODEL.ACT_CHECKPOINT, TPU.REMAT_MIN_SEQ), as the JAX package's does;
the decoder's blocks do not, as the JAX package builds them plain.

HOG's orientation bins are a decision, like a ReLU: a pixel whose angle
lies within a rounding of a bin edge takes either bin. ``hog_bins`` gives
every pixel's bin, and the forward and ``hog_targets`` take bins to hold
(``hog_bins=``), so that two sides can be compared with one side's bins.

Inside ``parallel.mesh.sequence_parallel`` (TPU.SHARD_STRATEGY dp_sp) the
input is a rank's frames of the clip, the mask its token planes, and every
output its planes: the patch grid is the rank's (its frames, a multiple of
the patch's T stride), HOG's gradients are spatial and take no halo, the
backbone runs MViT's sliced path, a T resize of the backbone's tokens
gathers the clip's planes first, and the decoder's position table is cut
to the rank's planes while its blocks gather K and V over T, as the
backbone's do.
"""

import math

import numpy as np
import torch
from torch import nn

from pmv_tpu_torch.models.attention import MultiScaleBlock
from pmv_tpu_torch.models.build import MODEL_REGISTRY
from pmv_tpu_torch.models.common import LayerNorm, Linear
from pmv_tpu_torch.models.mvit import MViT, geometry
from pmv_tpu_torch.parallel import mesh


def _gradients(frames):
    """Central differences along W and H, zero at the borders."""
    zero_w = frames.new_zeros(frames[:, :, :, :1].shape)
    zero_h = frames.new_zeros(frames[:, :, :1].shape)
    gx = torch.cat([zero_w, frames[:, :, :, 2:] - frames[:, :, :, :-2], zero_w], dim=3)
    gy = torch.cat([zero_h, frames[:, :, 2:] - frames[:, :, :-2], zero_h], dim=2)
    return gx, gy


def hog_bins(frames, nbins=9):
    """The unsigned orientation bin of each pixel and channel of ``frames``
    [B, T, H, W, C] (float32): ``floor((atan2(gy, gx) mod pi) / (pi /
    nbins)) mod nbins`` (`masked.py:35-36` of the JAX package). An angle of
    pi (gy = 0, gx < 0) lands in bin 0, as there: pi and the divisor are
    both float32's pi."""
    gx, gy = _gradients(frames)
    pi = torch.tensor(math.pi, dtype=frames.dtype, device=frames.device)
    ang = torch.remainder(torch.atan2(gy, gx), pi)
    return torch.remainder(torch.floor(ang / (math.pi / nbins)).long(), nbins)


def hog_targets(frames, nbins=9, cell_sz=8, bins=None):
    """Per-cell HOG descriptors of ``frames`` [B, T, H, W, C] (float32):
    [B, T, H // cell_sz, W // cell_sz, C * nbins], each cell's histogram of
    gradient magnitudes over ``nbins`` unsigned orientations per channel,
    L2-normalised (`pmv_tpu/models/masked.py:23-47`). ``bins`` (``hog_bins``'
    shape) holds the bins; by default each pixel takes its own."""
    gx, gy = _gradients(frames)
    mag = torch.sqrt(gx ** 2 + gy ** 2 + 1e-12)
    if bins is None:
        bins = hog_bins(frames, nbins)
    b, t, h, w, c = frames.shape
    hc, wc = h // cell_sz, w // cell_sz
    mag = mag[:, :, :hc * cell_sz, :wc * cell_sz]
    bins = bins.to(frames.device)[:, :, :hc * cell_sz, :wc * cell_sz]
    weighted = mag.new_zeros((*mag.shape, nbins)).scatter_(-1, bins[..., None], mag[..., None])
    hist = weighted.reshape(b, t, hc, cell_sz, wc, cell_sz, c, nbins).sum(dim=(3, 5))
    hist = hist.reshape(b, t, hc, wc, c * nbins)
    return hist / (torch.linalg.vector_norm(hist, dim=-1, keepdim=True) + 1e-6)


def nearest_indices(size_in, size_out):
    """Source index of each of ``size_out`` positions resized from
    ``size_in`` by ``jax.image.resize(..., "nearest")``: floor((d + 0.5) *
    in / out) in float32. ``F.interpolate(mode="nearest")`` takes floor(d *
    in / out), which differs at ratios that are not integers."""
    d = np.arange(size_out, dtype=np.float32)
    return np.floor((d + np.float32(0.5)) * np.float32(size_in) / np.float32(size_out)).astype(
        np.int64)


def resize_nearest(grid, size):
    """``grid`` [B, T, H, W, C] to [B, *size, C] by nearest neighbours, as
    ``jax.image.resize(..., "nearest")`` (``nearest_indices``)."""
    for axis, n in zip((1, 2, 3), size):
        if grid.shape[axis] != n:
            index = torch.as_tensor(nearest_indices(grid.shape[axis], n), device=grid.device)
            grid = grid.index_select(axis, index)
    return grid


class MSSeparateHead(nn.Module):
    """Per-target prediction head (`head_helper.py:580-690`): LayerNorm,
    then a linear to the target's width."""

    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.norm = LayerNorm(dim_in)
        self.projection = Linear(dim_in, dim_out)

    def forward(self, x):
        return self.projection(self.norm(x))


class MaskMViT(nn.Module):
    """MViT backbone with mask-token substitution and a prediction head.

    forward(x [B, T, H, W, C] float, mask [B, n_tok] bool, True = masked)
    -> (pred [B, n_tok, D], target [B, n_tok, D] float32, mask)."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        if len(cfg.MVIT.PATCH_STRIDE) == 2:  # 2-D image MaskFeat (in1k)
            self.patch = (1, *cfg.MVIT.PATCH_STRIDE)
        else:
            self.patch = tuple(cfg.MVIT.PATCH_STRIDE)
        self.num_frames = cfg.DATA.NUM_FRAMES
        self.mask_ratio = cfg.AUG.MASK_RATIO or 0.4
        self.pred_hog = cfg.MASK.PRED_HOG
        self.hog_nbins = cfg.MASK.HOG_NBINS
        self.time_stride_loss = cfg.MASK.TIME_STRIDE_LOSS
        self.norm_pred_pixel = cfg.MASK.NORM_PRED_PIXEL
        self.cls_on = cfg.MVIT.CLS_EMBED_ON
        channels = cfg.DATA.INPUT_CHANNEL_NUM[0]
        t_tok, h_tok, w_tok = self.token_grid((1, *geometry(cfg), channels))
        pt, ph, pw = self.patch

        self.mask_token = nn.Parameter(torch.zeros(1, 1, channels))
        self.backbone = MViT(cfg, dtype=dtype, head=False)
        dim = self.backbone.dim_out
        self.decoder_depth = cfg.MASK.DECODER_DEPTH
        self.decoder_sep_pos = cfg.MASK.DECODER_SEP_POS_EMBED
        if self.decoder_depth > 0:
            # Decoder stack (`masked.py:168-214`): the decoder's width, a
            # learned position table, blocks over the whole token grid.
            dec_dim = cfg.MASK.DECODER_EMBED_DIM
            self.decoder_embed = Linear(dim, dec_dim)
            if self.decoder_sep_pos:
                self.decoder_pos_embed_spatial = nn.Parameter(
                    torch.zeros(1, h_tok * w_tok, dec_dim))
                self.decoder_pos_embed_temporal = nn.Parameter(torch.zeros(1, t_tok, dec_dim))
            else:
                self.decoder_pos_embed = nn.Parameter(
                    torch.zeros(1, t_tok * h_tok * w_tok, dec_dim))
            self.decoder_blocks = nn.ModuleList(
                MultiScaleBlock(
                    dim=dec_dim, dim_out=dec_dim, num_heads=cfg.MASK.DEC_NUM_HEADS,
                    input_size=(t_tok, h_tok, w_tok), has_cls_embed=False,
                    kernel_kv=tuple(cfg.MASK.DEC_KV_KERNEL),
                    stride_kv=tuple(cfg.MASK.DEC_KV_STRIDE),
                )
                for _ in range(self.decoder_depth)
            )
            dim = dec_dim
        if self.pred_hog:
            target_dim = channels * self.hog_nbins
        else:
            target_dim = (1 if self.time_stride_loss else pt) * ph * pw * channels
        self.pred_head = MSSeparateHead(dim, target_dim)

    def token_grid(self, shape):
        """(t_tok, h_tok, w_tok): the patch grid of an input of ``shape``
        [B, T, H, W, C]; inside ``mesh.sequence_parallel`` the grid of a
        rank's T frames, which the patch's T stride must divide."""
        pt, ph, pw = self.patch
        if mesh.active() is None:
            return max(self.num_frames // pt, 1), shape[2] // ph, shape[3] // pw
        if shape[1] % pt:
            raise ValueError(f"a rank's {shape[1]} frames are not a multiple of the patch's T "
                             f"stride {pt}: give each rank a multiple of it (DATA.NUM_FRAMES / "
                             "the model axis)")
        return shape[1] // pt, shape[2] // ph, shape[3] // pw

    def sample_mask(self, shape, generator, device=None):
        """The model's own random mask for an input of ``shape``: [B, n_tok]
        bool with exactly ``int(n_tok * ratio)`` True a row, each token
        equally likely (`masked.py:89-95`), drawn from ``generator``."""
        n_tok = int(np.prod(self.token_grid(shape)))
        scores = torch.rand((shape[0], n_tok), generator=generator, device=device)
        k = int(n_tok * self.mask_ratio)
        thresh = torch.sort(scores, dim=1).values[:, k:k + 1]
        return scores < thresh

    def sample_drop_path_masks(self, batch, generator, device=None):
        """The backbone's DropPath keep masks (``MViT.sample_drop_path_masks``);
        the decoder's blocks drop no path."""
        return self.backbone.sample_drop_path_masks(batch, generator, device)

    def sample_dropout_masks(self, shape, generator, device=None):
        """The backbone's MVIT.DROPOUT_RATE keep masks for an input of
        ``shape`` (``MViT.sample_dropout_masks``; None at rate 0); the
        decoder's blocks drop nothing."""
        return self.backbone.sample_dropout_masks(shape, generator, device)

    def targets(self, x, hog_bins=None):
        """The regression targets of ``x`` [B, T, H, W, C], float32 [B, n_tok,
        D]: HOG on the patch grid (cell = the spatial patch stride, averaged
        over the frames of a temporal patch), or the patches' pixels (one
        frame a temporal patch under TIME_STRIDE_LOSS, normalised per patch
        under NORM_PRED_PIXEL; `masked.py:97-131`)."""
        b = x.shape[0]
        t_tok, h_tok, w_tok = self.token_grid(x.shape)
        n_tok = t_tok * h_tok * w_tok
        x = x.float()
        if self.pred_hog:
            hog = hog_targets(x, nbins=self.hog_nbins, cell_sz=self.patch[1], bins=hog_bins)
            hog = hog.reshape(b, t_tok, hog.shape[1] // t_tok, h_tok, w_tok, -1).mean(dim=2)
            return hog.reshape(b, n_tok, -1)
        patches, _ = patchify_pixels(self.patch, self.time_stride_loss, x)
        if self.norm_pred_pixel:
            mean = patches.mean(dim=-1, keepdim=True)
            var = patches.var(dim=-1, unbiased=False, keepdim=True)
            patches = (patches - mean) / torch.sqrt(var + 1e-6)
        return patches

    def forward(self, x, mask, drop_path_masks=None, hog_bins=None, dropout_masks=None):
        b = x.shape[0]
        t_tok, h_tok, w_tok = self.token_grid(x.shape)
        n_tok = t_tok * h_tok * w_tok
        if mask.numel() != b * n_tok:
            raise ValueError(
                f"the mask holds {mask.numel() // max(b, 1)} tokens a clip, the patch grid "
                f"{t_tok}x{h_tok}x{w_tok} = {n_tok}: AUG.MASK_WINDOW_SIZE must be the patch "
                "grid (the input size over MVIT.PATCH_STRIDE)"
            )
        mask = mask.reshape(b, n_tok)
        target = self.targets(x, hog_bins)

        # Pixel-level substitution (`masked.py:133-147`): the masked
        # patches' pixels become the mask token.
        pt, ph, pw = self.patch
        pixel_mask = (mask.reshape(b, t_tok, h_tok, w_tok)
                      .repeat_interleave(pt, 1).repeat_interleave(ph, 2)
                      .repeat_interleave(pw, 3))[:, :x.shape[1], :x.shape[2], :x.shape[3]]
        x = torch.where(pixel_mask[..., None], self.mask_token[0, 0].to(x.dtype), x)

        feats, thw = self.backbone(x, return_features=True, drop_path_masks=drop_path_masks,
                                   dropout_masks=dropout_masks)
        if self.cls_on:
            feats = feats[:, 1:]
        lay = mesh.active()
        m = 0 if lay is None else lay.model
        if tuple(thw) != (t_tok, h_tok, w_tok):
            grid = feats.reshape(b, *thw, -1)
            if lay is not None and thw[0] != t_tok:  # nearest over the clip's planes
                grid = resize_nearest(mesh.gather_t(grid),
                                      (t_tok * lay.model_size, h_tok, w_tok))
                grid = grid[:, m * t_tok:(m + 1) * t_tok]
            feats = resize_nearest(grid, (t_tok, h_tok, w_tok)).reshape(b, n_tok, -1)
        if self.decoder_depth > 0:
            feats = self.decoder_embed(feats)
            if self.decoder_sep_pos:  # the rank's planes of the temporal table
                temporal = self.decoder_pos_embed_temporal[:, m * t_tok:(m + 1) * t_tok]
                pos = (self.decoder_pos_embed_spatial.repeat(1, t_tok, 1)
                       + temporal.repeat_interleave(h_tok * w_tok, dim=1))
            else:
                pos = self.decoder_pos_embed[:, m * n_tok:(m + 1) * n_tok]
            feats = feats + pos.to(feats.dtype)
            thw_dec = (t_tok, h_tok, w_tok)
            for block in self.decoder_blocks:
                feats, thw_dec = block(feats, thw_dec)
        return self.pred_head(feats), target, mask


def patchify_pixels(patch, time_stride_loss, frames):
    """[B, T, H, W, C] -> ([B, n_tok, D] pixel patches, geometry), the
    target's layout (`masked.py:218-237`): ``patch`` is MVIT.PATCH_STRIDE as
    (pt, ph, pw); under ``time_stride_loss`` one frame a temporal patch."""
    patch_t, patch_h, patch_w = patch
    frames_t = frames[:, ::patch_t] if time_stride_loss else frames
    b, tt, hh, ww, c = frames_t.shape
    h_tok, w_tok = hh // patch_h, ww // patch_w
    pt = 1 if time_stride_loss else patch_t
    t_tok = tt // pt
    patches = frames_t[:, :, :h_tok * patch_h, :w_tok * patch_w]
    patches = patches.reshape(b, t_tok, pt, h_tok, patch_h, w_tok, patch_w, c)
    patches = patches.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, t_tok * h_tok * w_tok, -1)
    return patches, (t_tok, h_tok, w_tok, pt, patch_h, patch_w, c)


def unpatchify_pixels(patches, geom):
    """Inverse of ``patchify_pixels``: [B, n_tok, D] -> [B, T', H', W', C]."""
    t_tok, h_tok, w_tok, pt, ph, pw, c = geom
    b = patches.shape[0]
    x = patches.reshape(b, t_tok, h_tok, w_tok, pt, ph, pw, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, t_tok * pt, h_tok * ph, w_tok * pw, c)


def mae_visualize(cfg, frames, pred, mask):
    """(original | masked | reconstructed) for VIS_MASK.ENABLE
    (`masked.py:249-267`, the reference's `_mae_visualize`): ``frames`` [B,
    T, H, W, C] in [0, 255], ``pred`` [B, n_tok, D] pixel predictions,
    ``mask`` [B, n_tok] (True = masked). Returns [B, 3, T', H', W', C] uint8."""
    patch = tuple(cfg.MVIT.PATCH_STRIDE)
    patches, geom = patchify_pixels(patch, cfg.MASK.TIME_STRIDE_LOSS, frames.float())
    m = mask.reshape(mask.shape[0], -1, 1).float()
    pred = pred.float()
    if cfg.MASK.NORM_PRED_PIXEL:
        # The predictions are normalised per patch: re-expand them with the
        # patch's own statistics, an approximate reconstruction.
        mean = patches.mean(dim=-1, keepdim=True)
        std = torch.sqrt(patches.var(dim=-1, unbiased=False, keepdim=True) + 1e-6)
        pred = pred * std + mean
    recon = unpatchify_pixels(pred * m + patches * (1 - m), geom)
    masked = unpatchify_pixels(patches * (1 - m), geom)
    orig = unpatchify_pixels(patches, geom)
    comp = torch.stack([orig, masked, recon], dim=1)
    return torch.clamp(comp, 0, 255).to(torch.uint8)


def masked_loss(pred, target, mask, count=None):
    """Mean squared error over the masked tokens only (`masked.py:270-274`),
    in float32 (float64 for float64 predictions): the sum over the masked
    tokens over ``count`` (at least 1), the count of masked tokens, by
    default ``mask``'s (in a multi-process job the global batch's)."""
    err = ((pred.to(torch.promote_types(pred.dtype, torch.float32)) - target) ** 2).mean(dim=-1)
    denom = torch.clamp(mask.sum() if count is None else count, min=1)
    return (err * mask).sum() / denom


@MODEL_REGISTRY.register(name="MaskMViT")
def build_mask_mvit(cfg, dtype=torch.float32):
    return MaskMViT(cfg, dtype=dtype)
