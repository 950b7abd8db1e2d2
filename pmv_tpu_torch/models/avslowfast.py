"""AVSlowFast: audio-visual SlowFast
(`MViT/slowfast/models/video_model_builder.py:127-1088`).

Counterpart of `pmv_tpu/models/avslowfast.py`, on channels-last tensors,
under the JAX module tree's names, so that ``utils/weights.state_dict_from_
jax`` carries a JAX tree over by its flax paths:

- the visual trunk is ``SlowFast``'s (``ResNetBasicStem``, per stage a
  ``PathwayStages`` of the slow and fast ``ResStage``s), the audio pathway
  ``s1.pathway2_stem`` (``AudioStem``) and ``s{2..5}.pathway2``
  (``AudioStage``, held in each stage beside the visual blocks): a 2-D
  ResNet over the log-mel spectrogram [B, T_spec, M, C] (one input channel),
  every conv an ``F.conv2d`` on the channels-last grid viewed as NCHW. Its
  widths follow the JAX package, not the reference: WIDTH_PER_GROUP //
  BETA_INV at the stem and the fast pathway's at each stage, a plain 2-D
  bottleneck (SLOWFAST.AU_BETA_INV, AU_ALPHA, AU_REDUCE_TF_DIM and
  RESNET.AUDIO_TRANS_FUNC are read nowhere there, nor here);
- after the stem and each of the first three stages, where SLOWFAST.
  FS_FUSION, AFS_FUSION or (with the misaligned audio) AVS_FLAG asks for
  it, ``FuseAV`` ``s{i}_fuse``: the fast-to-slow concat (``conv_f2s``,
  ``bn_f2s``), and the audio-to-slow sum: the audio's mean over the mels
  through AU_FUSION_CONV_NUM (K x 1) convs ``conv_a2fs_k`` with norms
  ``bn_a2fs_k`` over its time axis, the last of stride 2, resized along
  time to the slow pathway's T by ``attention.resize_axis`` (the JAX
  package's ``jax.image.resize(..., "linear")``, antialiased when it
  downsamples, which ``F.interpolate`` is not), broadcast over H and W and
  added times the DropPathway gate; and the AVS sync loss ``avs``
  (``AVSLoss``) of the pooled fused slow features against the pooled
  aligned and misaligned audio. After stage 5 the junction ``s5_fuse``
  only computes its AVS loss: it runs with both fusions at gate 0, and its
  fused output is thrown away, as in the JAX package;
- the head is ``ResNetBasicHead`` over three pathways: slow, fast and the
  audio's mean over the mels.

forward([slow, fast, audio]) -> class scores; in training with the
misaligned audio, forward([slow, fast, audio, audio_mis]) -> (scores,
{"s{i}_avs": loss}). The AVS projections and ``s5_fuse`` exist only in a
model built with DATA.GET_MISALIGNED_AUDIO (the JAX package creates them
only when its init sees ``audio_mis``, `pmv_tpu/engine/steps.py:414-416`),
which the loader then gives.

Under temporal sequence parallelism (TPU.SHARD_STRATEGY dp_sp,
``parallel/mesh.py``) the visual pathways hold a rank's planes and the audio
is whole on every rank of a model group, which runs the audio pathway
whole: the audio-to-slow sum takes the rank's planes of the audio resized
to the clip's slow T (``audio_planes``), and the pooled visual features of
the AVS loss, of the embeddings and of the head are the model group's means
(``mesh.t_mean``); the audio's means stay each rank's own. The audio
pathway's BatchNorm statistics combine the model group's copies of the same
rows, whose mean and biased variance are those of one copy. Every
cross-rank step is a collective whose backward sums over the model group,
and the rest runs on each rank alone, so each rank's gradient is that of
its own loss, the losses over the world sum to M times the global batch's
(M the model axis), and DDP's mean over the M x D ranks gives the global
batch's gradient, the audio pathway's included.

DropPathway (`:894`) is a draw: one Bernoulli(SLOWFAST.DROPPATHWAY_RATE) a
train step, ``sample_drop_pathway``, which the step hands to forward as
``drop_pathway``, so that a test can hand both packages one decision. A
dropped step multiplies the fused audio by 0: the ``conv_a2fs`` stacks and
their BatchNorms run as ever, and their running statistics move. The AVS
gates follow JAX's ``avs_pattern`` (`:306-320`): every flagged junction
when dropped, else only those up to the earliest AFS junction.

The AVS loss (`AVSLoss`) runs in float32 whatever the activations' dtype
(float64 for float64 ones), as do ``audio_pair_mask``'s silent and
near-duplicate filter. In a multi-process job its sums are the global
batch's: the masked pair count is summed over the ranks, and each rank's
numerators are scaled by the world size, so that the ranks' mean, which
DDP's averaged gradient follows, is the global loss.
"""

import torch
import torch.nn.functional as F
from torch import nn

from pmv_tpu_torch.models.attention import resize_axis
from pmv_tpu_torch.models.batchnorm import get_norm
from pmv_tpu_torch.models.build import MODEL_REGISTRY
from pmv_tpu_torch.models.common import Linear
from pmv_tpu_torch.models.heads import ResNetBasicHead
from pmv_tpu_torch.models.resnet import (
    _TEMPORAL_KERNEL_BASIS_SLOWFAST,
    _ResNetBase,
    _stage_dims,
)
from pmv_tpu_torch.models.resnet_helper import PathwayStages, ResStage, conv
from pmv_tpu_torch.models.stem import ResNetBasicStem
from pmv_tpu_torch.parallel import distributed, mesh
from pmv_tpu_torch.utils.device import rank_and_world_size


class Conv2d(nn.Conv2d):
    """A bias-free nn.Conv2d's parameters on [B, H, W, C] tensors: ``F.conv2d``
    on the grid viewed as NCHW (channels-last in memory), in the input's
    dtype."""

    def __init__(self, dim_in, dim_out, kernel, stride=(1, 1), padding=(0, 0)):
        super().__init__(dim_in, dim_out, kernel, stride, padding, bias=False)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), None, self.stride,
                     self.padding)
        return y.permute(0, 2, 3, 1)


class AudioStem(nn.Module):
    """The spectrogram's stem: a (9 x 1) conv ``conv_t`` of stride 2 over
    time, a (1 x 9) conv ``conv_f`` of stride 2 over the mels, norm ``bn``,
    ReLU (`pmv_tpu/models/avslowfast.py:45`)."""

    def __init__(self, dim_out, norm):
        super().__init__()
        self.conv_t = Conv2d(1, dim_out, (9, 1), (2, 1), (4, 0))
        self.conv_f = Conv2d(dim_out, dim_out, (1, 9), (1, 2), (0, 4))
        self.bn = norm(dim_out)

    def forward(self, x):
        return F.relu(self.bn(self.conv_f(self.conv_t(x))))


class AudioStage(nn.Module):
    """A stage of 2-D bottleneck blocks ``b{i}_{a,b,c}`` (1x1 of stride s on
    the first block, 3x3, 1x1; each with its norm ``_bn``), the shortcut
    ``b{i}_proj`` and ``b{i}_proj_bn`` where the width or the grid changes
    (`pmv_tpu/models/avslowfast.py:68`)."""

    def __init__(self, dim_in, dim_out, dim_inner, num_blocks, stride, norm):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            s = stride if i == 0 else 1
            d_in = dim_in if i == 0 else dim_out
            self.add_module(f"b{i}_a", Conv2d(d_in, dim_inner, (1, 1), (s, s)))
            self.add_module(f"b{i}_a_bn", norm(dim_inner))
            self.add_module(f"b{i}_b", Conv2d(dim_inner, dim_inner, (3, 3), padding=(1, 1)))
            self.add_module(f"b{i}_b_bn", norm(dim_inner))
            self.add_module(f"b{i}_c", Conv2d(dim_inner, dim_out, (1, 1)))
            self.add_module(f"b{i}_c_bn", norm(dim_out))
            if d_in != dim_out or s != 1:
                self.add_module(f"b{i}_proj", Conv2d(d_in, dim_out, (1, 1), (s, s)))
                self.add_module(f"b{i}_proj_bn", norm(dim_out))

    def forward(self, x):
        for i in range(self.num_blocks):
            m = lambda name: getattr(self, f"b{i}_{name}")  # noqa: E731
            h = F.relu(m("a_bn")(m("a")(x)))
            h = F.relu(m("b_bn")(m("b")(h)))
            h = m("c_bn")(m("c")(h))
            if hasattr(self, f"b{i}_proj"):
                x = m("proj_bn")(m("proj")(x))
            x = F.relu(x + h)
        return x


def _l2_half(x):
    return 0.5 * x / (x.norm(dim=-1, keepdim=True) + 1e-12)


class AVSLoss(nn.Module):
    """The AVS sync loss of one junction (`pmv_tpu/models/avslowfast.py:113`):
    ``ref_fc`` projects the visual features, ``query_fc`` the aligned and
    the misaligned audio; each L2-normalised to 0.5; the masked mean of the
    aligned pairs' squared distance and of the misaligned pairs' hinge
    ``max(margin - distance, 0)^2``. In float32 (float64 for float64
    inputs); the global batch's in a multi-process job (module
    docstring)."""

    def __init__(self, dim_in, proj_dim):
        super().__init__()
        self.ref_fc = Linear(dim_in, proj_dim)
        self.query_fc = Linear(dim_in, proj_dim)

    def forward(self, ref, pos, neg, audio_mask, margin=0.99):
        ref = _l2_half(self.ref_fc(ref))
        pos = _l2_half(self.query_fc(pos))
        neg = _l2_half(self.query_fc(neg))
        mask = audio_mask.to(ref.dtype)
        n = mask.sum()
        pos_loss = (mask * (ref - pos).square().sum(dim=-1)).sum()
        neg_dist = torch.sqrt((ref - neg).square().sum(dim=-1) + 1e-12)
        neg_loss = (mask * torch.clamp(margin - neg_dist, min=0.0).square()).sum()
        world = rank_and_world_size()[1]
        if world > 1:  # this rank's share of the global loss, times the world
            n = distributed.all_reduce_sum(n.detach())
            return (pos_loss + neg_loss) * world / (2.0 * n + 1e-8)
        return (pos_loss + neg_loss) / (2.0 * n + 1e-8)


def audio_pair_mask(a_pos, a_neg, var_thresh, dup_thresh):
    """The pairs the AVS loss counts (`video_model_builder.py:944-965`
    filter_duplicates): both clips' (population) variance over
    ``var_thresh``, and their cosine similarity under ``dup_thresh``. No
    gradient."""
    p = a_pos.detach().reshape(a_pos.shape[0], -1)
    n = a_neg.detach().reshape(a_neg.shape[0], -1)
    var_ok = (p.var(dim=1, correction=0) > var_thresh) & (n.var(dim=1, correction=0) > var_thresh)
    pn = p / (p.norm(dim=1, keepdim=True) + 1e-12)
    nn_ = n / (n.norm(dim=1, keepdim=True) + 1e-12)
    return var_ok & ((pn * nn_).sum(dim=1) < dup_thresh)


def audio_planes(a, t):
    """[B, T_a, C] audio resized along time to the slow pathway's planes, of
    which a rank holds ``t``: to the clip's slow T (``resize_axis``), then,
    inside ``mesh.sequence_parallel``, the rank's planes of it (the audio
    is whole on every rank)."""
    lay = mesh.active()
    if lay is None:
        return resize_axis(a, 1, t)
    start, stop = lay.planes(t * lay.model_size)
    return resize_axis(a, 1, t * lay.model_size)[:, start:stop]


class FuseAV(nn.Module):
    """One junction (`pmv_tpu/models/avslowfast.py:134`): the fast-to-slow
    concat where ``use_fs``; the audio conv stack where ``use_afs`` or
    ``use_avs``, added onto the slow pathway times the DropPathway gate where
    ``use_afs``; the AVS loss (``avs``) where ``use_avs`` (a model with the
    misaligned audio)."""

    def __init__(self, dim_in_s, dim_in_f, ratio, kernel_f, alpha, dim_in_a, interm_dim,
                 kernel_a, conv_num_a, use_fs, use_afs, use_avs, avs_proj_dim, norm):
        super().__init__()
        self.use_fs, self.use_afs, self.use_avs = use_fs, use_afs, use_avs
        if use_fs:
            self.conv_f2s = conv(dim_in_f, dim_in_f * ratio, (kernel_f, 1, 1), (alpha, 1, 1),
                                 (kernel_f // 2, 0, 0))
            self.bn_f2s = norm(dim_in_f * ratio)
        self.conv_num_a = conv_num_a if use_afs or use_avs else 0
        dim_out = dim_in_s + (dim_in_f * ratio if use_fs else 0)
        for k in range(self.conv_num_a):
            last = k == conv_num_a - 1
            self.add_module(f"conv_a2fs_{k}", Conv2d(
                dim_in_a if k == 0 else interm_dim, dim_out if last else interm_dim,
                (kernel_a, 1), (2 if last else 1, 1), (kernel_a // 2, 0)))
            self.add_module(f"bn_a2fs_{k}", norm(dim_out if last else interm_dim))
        if use_avs:
            self.avs = AVSLoss(dim_out, avs_proj_dim)

    def a2fs(self, a):
        """[B, T_a, M, C] -> the mels' mean through the conv stack ->
        [B, T_a', C_out]."""
        a = a.mean(dim=2, keepdim=True)
        for k in range(self.conv_num_a):
            a = F.relu(getattr(self, f"bn_a2fs_{k}")(getattr(self, f"conv_a2fs_{k}")(a)))
        return a[:, :, 0, :]

    def forward(self, x_s, x_f, x_pos, x_neg, afs_gate, avs_gate, audio_mask):
        """(the fused slow pathway, the AVS loss or None); ``x_neg`` None
        without the misaligned audio."""
        fuse = x_s
        if self.use_fs:
            fs = F.relu(self.bn_f2s(self.conv_f2s(x_f)))
            fuse = torch.cat([fuse, fs], dim=-1)
        use_avs = self.use_avs and x_neg is not None
        if not (self.use_afs or use_avs):
            return fuse, None
        a_pos = self.a2fs(x_pos)
        a_neg = self.a2fs(x_neg) if use_avs else None
        if self.use_afs:
            fuse = fuse + afs_gate * audio_planes(a_pos, fuse.shape[1]).to(
                fuse.dtype)[:, :, None, None, :]
        loss = None
        if use_avs:
            ft = torch.promote_types(fuse.dtype, torch.float32)
            loss = self.avs(mesh.t_mean(fuse, (1, 2, 3)).to(ft), a_pos.mean(dim=1).to(ft),
                            a_neg.mean(dim=1).to(ft), audio_mask) * avs_gate
        return fuse, loss


class AVSlowFast(_ResNetBase):
    """Config-driven audio-visual SlowFast (module docstring)."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__(cfg, dtype)
        sf = cfg.SLOWFAST
        tk = _TEMPORAL_KERNEL_BASIS_SLOWFAST
        width, beta, ratio = cfg.RESNET.WIDTH_PER_GROUP, sf.BETA_INV, sf.FUSION_CONV_CHANNEL_RATIO
        norm = get_norm(cfg)
        self.fs_fusion = list(sf.FS_FUSION)
        self.afs_fusion = list(sf.AFS_FUSION)
        self.avs_flag = list(sf.AVS_FLAG)
        self.misaligned = bool(cfg.DATA.GET_MISALIGNED_AUDIO)
        self.drop_pathway_rate = sf.DROPPATHWAY_RATE
        self.var_thresh, self.dup_thresh = sf.AVS_VAR_THRESH, sf.AVS_DUPLICATE_THRESH
        if sf.AU_FUSION_CONV_CHANNEL_MODE == "ByDim":
            interm = lambda dim_a: max(1, int(sf.AU_FUSION_CONV_CHANNEL_DIM))  # noqa: E731
        else:
            interm = lambda dim_a: max(1, int(dim_a * sf.AU_FUSION_CONV_CHANNEL_RATIO))  # noqa: E731

        def junction(idx, dim_s, dim_f, use_fs, use_afs):
            return FuseAV(dim_s, dim_f, ratio, sf.FUSION_KERNEL_SZ, sf.ALPHA, dim_f,
                          interm(dim_f), sf.AU_FUSION_KERNEL_SZ, sf.AU_FUSION_CONV_NUM,
                          use_fs, use_afs, self.avs_flag[idx] and self.misaligned,
                          sf.AVS_PROJ_DIM, norm)

        self.s1 = nn.ModuleDict({
            **{f"pathway{p}_stem": ResNetBasicStem(
                cfg.DATA.INPUT_CHANNEL_NUM[p], width // (beta if p else 1),
                (tk[0][p][0], 7, 7), (1, 2, 2), (tk[0][p][0] // 2, 3, 3)) for p in (0, 1)},
            "pathway2_stem": AudioStem(width // beta, norm),
        })
        if self._has_junction(0, self.misaligned):
            self.s1_fuse = junction(0, width, width // beta, self.fs_fusion[0],
                                    self.afs_fusion[0])
        for s, (dim_in, dim_out, dim_inner, blocks) in enumerate(_stage_dims(cfg)):
            stride = 1 if s == 0 else 2
            paths = [ResStage(
                dim_in + (dim_in // beta * ratio if self.fs_fusion[s] else 0) if p == 0
                else dim_in // beta,
                dim_out // (beta if p else 1), dim_inner // (beta if p else 1), tk[s + 1][p],
                stride, blocks, cfg.RESNET.NUM_GROUPS, blocks, "bottleneck_transform",
                norm=norm, pathway=p,
            ) for p in (0, 1)]
            stage = PathwayStages(paths)
            stage.add_module("pathway2", AudioStage(dim_in // beta, dim_out // beta,
                                                    dim_inner // beta, blocks, stride, norm))
            setattr(self, f"s{s + 2}", stage)
            j = s + 1
            if j < 4 and self._has_junction(j, self.misaligned):
                setattr(self, f"s{j + 1}_fuse", junction(
                    j, dim_out, dim_out // beta, self.fs_fusion[j], self.afs_fusion[j]))
            elif j == 4 and self.avs_flag[4] and self.misaligned:
                self.s5_fuse = junction(4, dim_out, dim_out // beta, True, True)
        self.head = ResNetBasicHead([width * 32, width * 32 // beta, width * 32 // beta],
                                    cfg.MODEL.NUM_CLASSES, cfg.MODEL.DROPOUT_RATE,
                                    cfg.MODEL.HEAD_ACT, replicated=(2,))

    def _has_junction(self, idx, misaligned):
        return self.fs_fusion[idx] or self.afs_fusion[idx] or (self.avs_flag[idx] and misaligned)

    def sample_drop_pathway(self, generator):
        """DropPathway's draw of a train step: whether the audio's fusion is
        dropped, a host bool from ``generator`` (a CPU generator, so that
        every rank of a job takes the same decision from the same seed)."""
        rate = self.drop_pathway_rate
        return bool(rate > 0 and float(torch.rand((), generator=generator)) < rate)

    def _gates(self, dropped):
        """(the audio fusion's gate, each junction's AVS gate): JAX's
        ``avs_pattern`` (`pmv_tpu/models/avslowfast.py:306-320`)."""
        earliest = min([i for i in range(4) if self.afs_fusion[i]], default=4)
        avs = [0.0 if not flag else 1.0 if dropped or i <= earliest else 0.0
               for i, flag in enumerate(self.avs_flag)]
        return (0.0 if dropped else 1.0), avs

    def forward(self, x, drop_path_masks=None, head_dropout_mask=None, hw_switch=False,
                drop_pathway=False, return_embeddings=False):
        """``x`` is [slow, fast, audio] or [slow, fast, audio, audio_mis], the
        audio [B, T_spec, M] (or [B, T_spec, M, 1]); ``drop_pathway``
        (``sample_drop_pathway``) applies in training only;
        ``head_dropout_mask`` as ``SlowFast``'s; ``hw_switch`` changes nothing
        (the steps refuse portrait rows here). With ``return_embeddings``
        (the visual embedding, the audio embedding): the pooled slow and
        fast features concatenated, and the pooled audio."""
        if not (isinstance(x, (list, tuple)) and len(x) in (3, 4)):
            raise ValueError("AVSlowFast takes [slow, fast, audio(, audio_mis)] "
                             "(steps.pack_pathways)")
        x_neg = x[3] if len(x) == 4 else None
        if x_neg is not None and not self.misaligned:
            raise ValueError("misaligned audio given to an AVSlowFast built without "
                             "DATA.GET_MISALIGNED_AUDIO (it has no AVS projections)")
        misaligned = x_neg is not None
        afs_gate, avs_gates = self._gates(bool(drop_pathway) and self.training)
        audio = [a if a.dim() == 4 else a[..., None] for a in x[2:]]
        mask = (audio_pair_mask(audio[0], audio[1], self.var_thresh, self.dup_thresh)
                if misaligned else None)

        dt = self.compute_dtype
        x_s = self.s1["pathway0_stem"](x[0].to(dt))
        x_f = self.s1["pathway1_stem"](x[1].to(dt))
        a = [self.s1["pathway2_stem"](t.to(dt)) for t in audio]
        losses = {}

        def fuse(idx, x_s, x_f, afs_gate):
            out, loss = getattr(self, f"s{idx + 1}_fuse")(
                x_s, x_f, a[0], a[1] if misaligned else None, afs_gate, avs_gates[idx], mask)
            if loss is not None:
                losses[f"s{idx + 1}_avs"] = loss
            return out

        if self._has_junction(0, misaligned):
            x_s = fuse(0, x_s, x_f, afs_gate)
        for s, stage in enumerate(self.stages()):
            x_s, x_f = stage([x_s, x_f])
            a = [stage.pathway2(t) for t in a]
            j = s + 1
            if j < 4 and self._has_junction(j, misaligned):
                x_s = fuse(j, x_s, x_f, afs_gate)
            elif j == 4 and self.avs_flag[4] and misaligned:
                fuse(4, x_s, x_f, 0.0)  # the AVS loss alone; the fused output goes
        if return_embeddings:
            v_emb = torch.cat([mesh.t_mean(x_s, (1, 2, 3)), mesh.t_mean(x_f, (1, 2, 3))],
                              dim=-1)
            return v_emb, a[0].mean(dim=(1, 2))
        out = self.head([x_s, x_f, a[0].mean(dim=2)[:, :, None, None, :]], head_dropout_mask)
        if self.training and misaligned:
            return out, losses
        return out


def avs_loss(v_emb, a_emb_pos, a_emb_neg, margin=0.5):
    """The standalone triplet sync loss over pooled embeddings
    (`pmv_tpu/models/avslowfast.py:465`): mean(max(0, margin - cos(v, a+)
    + cos(v, a-)))."""

    def cos(a, b):
        a = a / (a.norm(dim=-1, keepdim=True) + 1e-8)
        b = b / (b.norm(dim=-1, keepdim=True) + 1e-8)
        return (a * b).sum(dim=-1)

    return torch.clamp(margin - cos(v_emb, a_emb_pos) + cos(v_emb, a_emb_neg), min=0.0).mean()


@MODEL_REGISTRY.register(name="AVSlowFast")
def build_avslowfast(cfg, dtype=torch.float32):
    return AVSlowFast(cfg, dtype=dtype)
