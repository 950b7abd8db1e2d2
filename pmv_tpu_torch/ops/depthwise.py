"""Stride-1, SAME, 3x3x3 depthwise conv3d on channels-last tensors, with its
gradient.

The port's counterpart of ``pmv_tpu/ops/depthwise_pallas.py``. MViT sends
its stride-1 3x3x3 pooling convs here (``models/attention.py``), UniFormer
its DPE convs (``models/uniformer.py``), X3D its stride-1 channelwise
convs (``models/resnet_helper.py``).

- ``depthwise3x3x3(x, w)``: differentiable, a ``torch.autograd.Function``
  as the JAX package's ``custom_vjp``. The forward is the kernel K1,
  ``csrc/depthwise3x3x3.cu`` (it replaces the TPU kernel
  ``depthwise3x3x3_fwd``, body ``_dw_fwd_kernel``). The backward computes
  dx as K1 on the cotangent with the weights flipped on all three axes, and
  dw with the kernel ``csrc/depthwise3x3x3_wgrad.cu`` (``_bwd``'s 27
  shifted reductions), accumulated in float32 and cast to ``w.dtype``.
- ``depthwise3x3x3_wgrad(x, g)``: the weight-gradient kernel's wrapper.
- Any C, as the TPU kernel takes any C (it pads the channels to a multiple
  of 128, `depthwise_pallas.py:85-96`): the kernels stage 16-byte units of
  channels, so on the card a C that is not a multiple of 8 is padded with
  zeros to the next one, and the output (or dw) sliced back
  (``channel_padded``; the autograd Function pads x, w and the cotangent
  once a layer). X3D-M's C = 54 and 108 take this path.
- ``depthwise3x3x3_plain`` and ``depthwise3x3x3_wgrad_plain``: pad, then 27
  shifted products in float32. The CPU path, and the references the
  kernels are held against.
- ``plan_forward`` and ``plan_wgrad``: the kernels' launch plans (tiles,
  threads, shared memory) by one rule, worked out here so that the CPU
  tests can check them.
- ``MVIT_POOL_SHAPES``, ``MASKFEAT_POOL_SHAPES``, ``MVIT_RECT_POOL_SHAPES``,
  ``MVIT_PORTRAIT_POOL_SHAPES``, ``MVIT_SP_POOL_SHAPES`` and
  ``MVIT_SP_SQUARE_POOL_SHAPES`` (a rank's under dp_sp),
  ``MVIT_RECT_TRAIN_POOL_SHAPES``, the ``UNIFORMER_*_DPE_SHAPES``, the
  ``X3D_*_DW_SHAPES``, the ``CSN_*DW_SHAPES``, ``ODD_SHAPES`` and
  ``PADDED_ODD_SHAPES``: the shapes the main paths give the kernels
  (MViT's pools, UniFormer's DPE convs and X3D-M's stride-1
  channelwise convs at the 224^2 crop, the PMV rect crop and its transposes
  at batch 8, at the PMV train step's batch of 16, X3D-M's test crop of
  256^2, and ir-CSN-101's conv_bs at 32 x 224^2 and at its 256^2 test
  crop), and
  the odd ones their tiling and the channel pad must take besides; the
  tests, ``chip_smoke.py`` and ``tools/plan_sweep.py`` take them from
  here.

A CUDA tensor launches the kernels; a CPU tensor takes the plain versions.
Nothing else falls back: a CUDA input the kernels do not take, a failed
build or a refused launch raises. Each wrapper counts its launches in
``.launches``. Inside ``record_shapes()`` the autograd Function's calls
(forward, dx and dw) note their input shapes, on either device: under
sequence parallelism they show the halo-extended T.

Bound on the card: bytes, for both kernels; see the kernel sources.
"""

import contextlib
import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from pmv_tpu_torch.ops.build import load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SMEM_PER_BLOCK = 232_448  # Hopper: the shared memory one block may take
H100_SMS = 132
# A plan takes the widest channel chunk, then the tallest tile (up to
# MAX_TILE_ROWS rows, cut evenly), then (wgrad) the most W segments of up to
# WGRAD_SEGMENT columns that fit a block, and cuts T into ranges until the
# grid holds two blocks and 6 warps for each SM of an H100.
MIN_BLOCKS = 2 * H100_SMS
MIN_THREADS = H100_SMS * 192
MAX_TILE_ROWS = 8
FWD_MAX_THREADS = 128  # the kernels' __launch_bounds__
WGRAD_MAX_THREADS = 512
FWD_MAX_CHUNK_LOG2 = 1  # K1 takes chunks of 1 or 2 16-byte units
WGRAD_MAX_CHUNK_LOG2 = 2
FWD_CHANNELS = 2  # channels a thread owns: K1's channels<T>()
WGRAD_CHANNELS = 4
FWD_SEGMENT = 7  # W columns a K1 thread owns: its kSegment
WGRAD_SEGMENT = 14  # the most W columns a wgrad thread walks

# The inputs MViTv2-S 16x4 gives the kernels at batch 8, with the launches
# of each in one forward: the stride-1 3x3x3 pools (C = heads * head_dim).
MVIT_POOL_SHAPES = (
    ((8, 8, 56, 56, 96), 1),    # q-pool, block 0
    ((8, 8, 28, 28, 192), 1),   # q-pool, block 2
    ((8, 8, 14, 14, 384), 10),  # q-pools, blocks 4-13
    ((8, 8, 14, 14, 768), 2),   # K and V pools, block 14
    ((8, 8, 7, 7, 768), 3),     # q, K and V pools, block 15
)
# MaskFeat pre-training of MViTv2-S 16x4
# (configs/masked_ssl/k400_MVITv2_S_16x4_MaskFeat_PT.yaml) keeps blocks 14 and
# 15 on the 14 x 14 grid: its stride-1 pools are q-pools only, 14 a forward,
# each at a shape of MVIT_POOL_SHAPES (whose plans and timings cover them).
MASKFEAT_POOL_SHAPES = (
    ((8, 8, 56, 56, 96), 1),    # q-pool, block 0
    ((8, 8, 28, 28, 192), 1),   # q-pool, block 2
    ((8, 8, 14, 14, 384), 10),  # q-pools, blocks 4-13
    ((8, 8, 14, 14, 768), 2),   # q-pools, blocks 14-15
)
# The same at the PMV rect crop (DATA.TRAIN_CROP_SIZE_RECT [256, 192],
# exps/PMV/run_MViT_PMV.sh): H > W, so the rel-pos tables swap under
# SWITCH_AUTO; then its transposes, the grids of the portrait rows, which
# run transposed through the switched forward.
MVIT_RECT_POOL_SHAPES = (
    ((8, 8, 64, 48, 96), 1),
    ((8, 8, 32, 24, 192), 1),
    ((8, 8, 16, 12, 384), 10),
    ((8, 8, 16, 12, 768), 2),
    ((8, 8, 8, 6, 768), 3),
)
MVIT_PORTRAIT_POOL_SHAPES = tuple(
    ((b, t, w, h, c), n) for (b, t, h, w, c), n in MVIT_RECT_POOL_SHAPES
)
# The same pools under TPU.SHARD_STRATEGY dp_sp on a model axis of 2, per rank
# (parallel/mesh.py): each rank's 4 of the 8 token planes and the halo plane
# either side, 6 planes where half of a whole clip's launch reads 4. The PMV
# rect crop's grids and their transposes at the batches a rank holds on the
# dp_sp paths (SP_BATCHES: a train step's 2 clips, and run_net's 4 when 2
# processes take 2 videos each); then the 224^2 crop's at batch 8, where
# the launches are long enough to show what the halo planes cost.
SP_BATCHES = (2, 4)
MVIT_SP_POOL_SHAPES = tuple(
    ((b, t // 2 + 2, h, w, c), n) for b in SP_BATCHES
    for (_, t, h, w, c), n in MVIT_RECT_POOL_SHAPES + MVIT_PORTRAIT_POOL_SHAPES
)
MVIT_SP_SQUARE_POOL_SHAPES = tuple(
    ((b, t // 2 + 2, h, w, c), n) for (b, t, h, w, c), n in MVIT_POOL_SHAPES
)
# The PMV recipe's train step through run_net takes TRAIN.BATCH_SIZE 8 x
# AUG.NUM_SAMPLE 2 = 16 clips (``multiple_samples_collate``): the rect grids,
# and their transposes, at that batch, where the plans cut T and the wgrad
# kernel's partial sums differ from batch 8's.
PMV_TRAIN_BATCH = 16
MVIT_RECT_TRAIN_POOL_SHAPES = tuple(
    ((PMV_TRAIN_BATCH, *s[1:]), n)
    for s, n in MVIT_RECT_POOL_SHAPES + MVIT_PORTRAIT_POOL_SHAPES
)
# UniFormer-S 16x4's DPE convs, one at the start of every block (3, 4, 8 and
# 3 per forward in its four stages), at batch 8: the 224^2 crop's grids, the
# PMV rect crop's (exps/PMV/run_Uniformer_PMV.sh) and their transposes; then
# all three at run_net's train batch of 16 clips. C = 64 is below MViT's
# smallest C (96).
UNIFORMER_DPE_SHAPES = (
    ((8, 8, 56, 56, 64), 3),
    ((8, 8, 28, 28, 128), 4),
    ((8, 8, 14, 14, 320), 8),
    ((8, 8, 7, 7, 512), 3),
)
UNIFORMER_RECT_DPE_SHAPES = (
    ((8, 8, 64, 48, 64), 3),
    ((8, 8, 32, 24, 128), 4),
    ((8, 8, 16, 12, 320), 8),
    ((8, 8, 8, 6, 512), 3),
)
UNIFORMER_PORTRAIT_DPE_SHAPES = tuple(
    ((b, t, w, h, c), n) for (b, t, h, w, c), n in UNIFORMER_RECT_DPE_SHAPES
)
UNIFORMER_TRAIN_DPE_SHAPES = tuple(
    ((PMV_TRAIN_BATCH, *s[1:]), n)
    for s, n in UNIFORMER_DPE_SHAPES + UNIFORMER_RECT_DPE_SHAPES + UNIFORMER_PORTRAIT_DPE_SHAPES
)
# The DPE convs under TPU.SHARD_STRATEGY dp_sp on a model axis of 2, per
# rank, as MVIT_SP_POOL_SHAPES: 4 of the 8 token planes and the halo plane
# either side, on the rect crop's grids and their transposes at SP_BATCHES.
UNIFORMER_SP_DPE_SHAPES = tuple(
    ((b, t // 2 + 2, h, w, c), n) for b in SP_BATCHES
    for (_, t, h, w, c), n in UNIFORMER_RECT_DPE_SHAPES + UNIFORMER_PORTRAIT_DPE_SHAPES
)
# ... and the recipe's 224^2 test crop (exps/PMV/run_Uniformer_PMV.sh), at
# the batch a rank holds in run_net's eval and test (2 videos a process).
UNIFORMER_SP_TEST_DPE_SHAPES = tuple(
    ((SP_BATCHES[-1], t // 2 + 2, h, w, c), n) for (_, t, h, w, c), n in UNIFORMER_DPE_SHAPES
)
# X3D-M's stride-1 channelwise Tx3x3 convs (configs/Kinetics/X3D_M.yaml:
# inner widths 54, 108, 216 and 432; blocks [3, 5, 11, 7], the first of each
# stage strided), at batch 8: the 224^2 train crop's grids, the PMV rect
# crop's (exps/PMV/run_X3D_PMV.sh, rect_256_192; run_net trains X3D at 8
# clips a step) and their transposes, and the recipe's 256^2 test crop. C =
# 54 and 108 are padded to 56 and 112 on the card.
X3D_DW_SHAPES = (
    ((8, 16, 56, 56, 54), 2),
    ((8, 16, 28, 28, 108), 4),
    ((8, 16, 14, 14, 216), 10),
    ((8, 16, 7, 7, 432), 6),
)
X3D_RECT_DW_SHAPES = (
    ((8, 16, 64, 48, 54), 2),
    ((8, 16, 32, 24, 108), 4),
    ((8, 16, 16, 12, 216), 10),
    ((8, 16, 8, 6, 432), 6),
)
X3D_PORTRAIT_DW_SHAPES = tuple(
    ((b, t, w, h, c), n) for (b, t, h, w, c), n in X3D_RECT_DW_SHAPES
)
X3D_TEST_DW_SHAPES = (
    ((8, 16, 64, 64, 54), 2),
    ((8, 16, 32, 32, 108), 4),
    ((8, 16, 16, 16, 216), 10),
    ((8, 16, 8, 8, 432), 6),
)
# ir-CSN-101's stride-1 depthwise conv_bs (configs/Kinetics/CSN_32x2_R101.yaml:
# inner widths 64, 128, 256 and 512; blocks [3, 4, 23, 3], the first of
# stages 3-5 strided (2, 2, 2)) at batch 8 on the 32 x 224^2 train crop,
# and on the recipe's 256^2 test crop.
CSN_DW_SHAPES = (
    ((8, 32, 56, 56, 64), 3),
    ((8, 16, 28, 28, 128), 3),
    ((8, 8, 14, 14, 256), 22),
    ((8, 4, 7, 7, 512), 2),
)
CSN_TEST_DW_SHAPES = (
    ((8, 32, 64, 64, 64), 3),
    ((8, 16, 32, 32, 128), 3),
    ((8, 8, 16, 16, 256), 22),
    ((8, 4, 8, 8, 512), 2),
)
# X3D-M's channelwise convs under TPU.SHARD_STRATEGY dp_sp on a model axis of
# 2, per rank, as MVIT_SP_POOL_SHAPES: 8 of the 16 frames and the halo plane
# either side, on the PMV rect crop's grids and their transposes at
# SP_BATCHES, and on the recipe's 256^2 test crop at the batch a rank holds
# in run_net's test (2 videos a process).
X3D_SP_DW_SHAPES = tuple(
    ((b, t // 2 + 2, h, w, c), n) for b in SP_BATCHES
    for (_, t, h, w, c), n in X3D_RECT_DW_SHAPES + X3D_PORTRAIT_DW_SHAPES
)
X3D_SP_TEST_DW_SHAPES = tuple(
    ((SP_BATCHES[-1], t // 2 + 2, h, w, c), n) for (_, t, h, w, c), n in X3D_TEST_DW_SHAPES
)
# ir-CSN-101's stride-1 conv_bs under dp_sp, per rank, at batch 2 on the
# 32 x 224^2 train crop: half of each stage's planes (16, 8, 4, 2) and the
# halo plane either side.
CSN_SP_DW_SHAPES = tuple(
    ((SP_BATCHES[0], t // 2 + 2, h, w, c), n) for (_, t, h, w, c), n in CSN_DW_SHAPES
)
# Shapes the tiling must take besides: C of 8, 24 and 40 (not multiples of
# a chunk), H and W of 1, 2, 7 and 13, portrait grids, T of 1 to 3, B of 1.
ODD_SHAPES = (
    (1, 1, 1, 1, 8),
    (1, 2, 2, 13, 40),
    (2, 3, 13, 7, 24),
    (1, 3, 7, 2, 24),
    (2, 2, 13, 1, 40),
    (1, 1, 7, 13, 8),
)
# Shapes whose C the wrappers pad on the card (12 and 54: X3D's smallest
# widths), off X3D's grids.
PADDED_ODD_SHAPES = (
    (1, 2, 5, 7, 12),
    (2, 3, 13, 6, 54),
    (1, 1, 2, 9, 54),
)
CHANNEL_MULTIPLE = 8  # the kernels' C: whole 16-byte units in both dtypes


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a kernel cuts [B, T, H, W, C]: a block owns one batch entry, ``tt``
    planes of T, ``th`` rows of H, all of W and ``2**nv_log2`` 16-byte units
    of channels, and walks its planes, copying the next ones into shared
    memory while it works on this one; a thread owns ``cpt`` channels, one
    row (and in the wgrad kernel one dt), and a segment of ``sw`` columns of
    W, one of ``nseg``. Staged rows are ``pitch`` (x, with its halo) and
    ``gpitch`` (g, wgrad only) 16-byte units wide."""

    shape: tuple
    elem_size: int
    wgrad: bool
    th: int
    nv_log2: int
    nseg: int
    sw: int
    pitch: int
    gpitch: int
    tt: int
    threads: int
    smem_bytes: int

    @property
    def cpt(self):
        """Channels a thread owns."""
        return WGRAD_CHANNELS if self.wgrad else FWD_CHANNELS

    @property
    def chunk(self):
        """Channels of a block."""
        return (16 // self.elem_size) << self.nv_log2

    @property
    def nhtiles(self):
        return -(-self.shape[2] // self.th)

    @property
    def nchunks(self):
        return self.shape[4] // self.chunk

    @property
    def nttiles(self):
        return -(-self.shape[1] // self.tt)

    @property
    def row_blocks(self):
        """Blocks of one chunk: the wgrad kernel's partial sums."""
        return self.shape[0] * self.nttiles * self.nhtiles

    @property
    def blocks(self):
        return self.row_blocks * self.nchunks


def _pitch(positions, nv):
    """16-byte units of a staged row; where one position is narrower than
    128 bytes, congruent to ``nv`` modulo 8, so that the rows one phase of a
    warp reads fall on different shared-memory banks."""
    units = positions * nv
    return units if nv >= 8 else units + (nv - units) % 8


def _lines(units):
    """16-byte units rounded up to whole 128-byte lines."""
    return -(-units // 8) * 8


def make_plan(shape, elem_size, wgrad, th, nv_log2, tsplit, nseg=None):
    """The plan of tiles of ``th`` rows, chunks of ``2**nv_log2`` units and
    ``tsplit`` ranges of T; W in ``nseg`` segments (the wgrad kernel; K1's
    segments are ``FWD_SEGMENT`` columns). None where a block would take
    more threads or shared memory than the kernel may."""
    _, t, _, w, _ = shape
    tt = max(1, -(-t // tsplit))
    nv = 1 << nv_log2
    if wgrad:
        sw = max(1, -(-w // nseg))
        nseg = max(1, -(-w // sw))
        nq = nv * (16 // elem_size) // WGRAD_CHANNELS  # threads across the chunk
        threads = nq * th * 3 * nseg
        pitch, gpitch = _pitch(w + 2, nv), _pitch(w, nv)
        # x ring of 4 planes, g ring of 2, in slots of 128-byte lines, then
        # 64 bytes of mbarriers; the block's final sum reuses them.
        smem = max((4 * _lines((th + 2) * pitch) + 2 * _lines(th * gpitch) + 4) * 16,
                   th * nseg * 27 * nq * WGRAD_CHANNELS * 4)
        max_threads = WGRAD_MAX_THREADS
    else:
        sw, nseg = FWD_SEGMENT, max(1, -(-w // FWD_SEGMENT))
        nq = nv * (16 // elem_size) // FWD_CHANNELS
        threads = nq * th * nseg
        pitch, gpitch = _pitch(nseg * sw + 2, nv), 0
        # The plane worked on and two in flight, in slots of 128-byte lines,
        # then 64 bytes of mbarriers.
        smem = (3 * _lines((th + 2) * pitch) + 4) * 16
        max_threads = FWD_MAX_THREADS
    # A tensor copy's box is at most 256 positions wide.
    if threads > max_threads or smem > SMEM_PER_BLOCK or pitch // nv > 256:
        return None
    return Plan(tuple(shape), elem_size, wgrad, th, nv_log2, nseg, sw, pitch,
                gpitch, tt, threads, smem)


def _plan(shape, elem_size, wgrad):
    _, t, h, w, c = shape
    if c <= 0 or c % 8:
        raise ValueError(f"C must be a positive multiple of 8, got {c}")
    nvec = c // (16 // elem_size)
    fits = (
        make_plan(shape, elem_size, wgrad, -(-h // -(-h // rows)) if h else 1,
                  nv_log2, 1, nseg)
        for nv_log2 in range(WGRAD_MAX_CHUNK_LOG2 if wgrad else FWD_MAX_CHUNK_LOG2, -1, -1)
        if nvec % (1 << nv_log2) == 0
        for rows in range(min(MAX_TILE_ROWS, max(h, 1)), 0, -1)  # even tiles
        for nseg in range(-(-w // WGRAD_SEGMENT) if wgrad else 1, 0, -1)
    )
    plan = next((p for p in fits if p is not None), None)
    if plan is None:
        raise ValueError(f"no launch plan fits shape {tuple(shape)}")
    for tsplit in range(2, max(t, 1) + 1):
        if plan.blocks >= MIN_BLOCKS and plan.blocks * plan.threads >= MIN_THREADS:
            break
        plan = make_plan(shape, elem_size, wgrad, plan.th, plan.nv_log2, tsplit, plan.nseg)
    return plan


@functools.lru_cache(maxsize=None)
def plan_forward(shape, elem_size):
    """K1's plan for x of ``shape`` [B, T, H, W, C] with ``elem_size``-byte
    elements, by the rule above. Cached: the main path asks for the same few
    shapes at every step."""
    return _plan(tuple(shape), elem_size, wgrad=False)


@functools.lru_cache(maxsize=None)
def plan_wgrad(shape, elem_size):
    """The wgrad kernel's plan, by the rule above, with W in segments of at
    most ``WGRAD_SEGMENT`` columns."""
    return _plan(tuple(shape), elem_size, wgrad=True)


def _accumulation_dtype(x):
    """float32, or float64 for a float64 input."""
    return torch.promote_types(x.dtype, torch.float32)


def depthwise3x3x3_plain(x, w):
    """x [B, T, H, W, C], w [3, 3, 3, C] -> [B, T, H, W, C] in x.dtype."""
    _, t, h, wd, _ = x.shape
    acc_dtype = _accumulation_dtype(x)
    xp = F.pad(x.to(acc_dtype), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = w.to(acc_dtype)
    acc = torch.zeros(x.shape, dtype=acc_dtype, device=x.device)
    for dt in range(3):
        for dh in range(3):
            for dw in range(3):
                acc += xp[:, dt:dt + t, dh:dh + h, dw:dw + wd] * wf[dt, dh, dw]
    return acc.to(x.dtype)


def depthwise3x3x3_wgrad_plain(x, g):
    """x, g [B, T, H, W, C] -> dw [3, 3, 3, C] in x.dtype:
    dw[dt, dh, dw, c] = sum over (b, t, h, w) of xpad[.., t+dt, h+dh, w+dw, c]
    * g[b, t, h, w, c], in float32 (float64 for float64 inputs)."""
    _, t, h, wd, c = x.shape
    acc_dtype = _accumulation_dtype(x)
    xp = F.pad(x.to(acc_dtype), (0, 0, 1, 1, 1, 1, 1, 1))
    gf = g.to(acc_dtype)
    taps = [
        (xp[:, dt:dt + t, dh:dh + h, dw:dw + wd] * gf).sum(dim=(0, 1, 2, 3))
        for dt in range(3) for dh in range(3) for dw in range(3)
    ]
    return torch.stack(taps).reshape(3, 3, 3, c).to(x.dtype)


def _function(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _check(op, x, other, other_shape):
    """Device, type, shape, contiguity and alignment of a kernel's inputs."""
    if x.device.type != "cuda":
        raise ValueError(f"{op} runs on cpu or cuda, not {x.device}")
    if x.dim() != 5 or tuple(other.shape) != tuple(other_shape):
        raise ValueError(
            f"{op} takes [B,T,H,W,C] and {list(other_shape)}, got "
            f"{tuple(x.shape)} and {tuple(other.shape)}"
        )
    if x.dtype not in _DTYPES or other.dtype != x.dtype:
        raise TypeError(
            f"{op} takes float32 or bfloat16 inputs of one type, got "
            f"{x.dtype} and {other.dtype}"
        )
    if other.device != x.device:
        raise ValueError(f"inputs on {x.device} and {other.device}")
    for t in (x, other):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{op} takes contiguous, 16-byte aligned inputs")


def _raise_on(err, op):
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: cudaError {err}")


def pad_channels(t):
    """``t`` with its last axis padded with zeros to the next multiple of
    ``CHANNEL_MULTIPLE``; ``t`` itself where it is one already."""
    pad = -t.shape[-1] % CHANNEL_MULTIPLE
    return F.pad(t, (0, pad)) if pad else t


def sliced_channels(t, c):
    """The first ``c`` channels (last axis) of ``t``, contiguous; ``t``
    itself where it has ``c``."""
    return t if t.shape[-1] == c else t[..., :c].contiguous()


def channel_padded(conv, x, other):
    """``conv(x, other)`` on channels padded with zeros to the next multiple
    of ``CHANNEL_MULTIPLE`` (the last axis of both: x and w, or x and g),
    with the last axis of its result sliced back to C; ``conv`` itself
    where C is such a multiple already. A zero channel of x meets a zero tap
    of w (or a zero cotangent), so the padded channels compute zeros and
    the others what they compute unpadded."""
    c = x.shape[-1]
    pad = -c % CHANNEL_MULTIPLE
    if pad == 0:
        return conv(x, other)
    return sliced_channels(conv(F.pad(x, (0, pad)), F.pad(other, (0, pad))), c)


_shapes = []  # the lists of the open record_shapes() contexts


@contextlib.contextmanager
def record_shapes():
    """A list that gets ("fwd", "dx" or "wgrad", [B, T, H, W, C]) for each
    call of K1 (the forward, dx) and of the weight gradient made within."""
    shapes = []
    _shapes.append(shapes)
    try:
        yield shapes
    finally:
        _shapes.remove(shapes)


def _note(kind, x):
    for shapes in _shapes:
        shapes.append((kind, tuple(x.shape)))


def _pads(x):
    """Whether the kernels' channel pad applies to ``x``: on the card."""
    return x.device.type == "cuda"


def _conv(x, w, kind="fwd"):
    """K1 on CUDA (one launch; C a multiple of 8), the plain version on the
    CPU; ``kind`` names the call in ``record_shapes``."""
    _note(kind, x)
    if x.device.type == "cpu":
        return depthwise3x3x3_plain(x, w)
    return _launch_forward(x, w)


def _wgrad(x, g):
    """The wgrad kernel on CUDA (C a multiple of 8), the plain version on the
    CPU."""
    _note("wgrad", x)
    if x.device.type == "cpu":
        return depthwise3x3x3_wgrad_plain(x, g)
    _check("depthwise3x3x3_wgrad", x, g, x.shape)
    return _launch_wgrad(x, g)


def _launch_forward(x, w):
    return _run_forward(x, w, plan_forward(tuple(x.shape), x.element_size()))


def _run_forward(x, w, p):
    """One launch of K1 on checked inputs with the plan ``p``."""
    fn = _function(load_library("depthwise3x3x3"), "pmv_dw3x3x3_fwd", 3, 14)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), *x.shape,
                 p.th, p.nv_log2, p.nseg, p.sw, p.pitch, p.tt, p.threads,
                 p.smem_bytes, _DTYPES[x.dtype], stream)
    _raise_on(err, "depthwise3x3x3")
    depthwise3x3x3.launches += 1
    return out


def depthwise3x3x3_wgrad(x, g):
    """x, g [B, T, H, W, C] -> dw [3, 3, 3, C] in x.dtype, the weight
    gradient of ``depthwise3x3x3`` (float32 accumulation). Two launches on
    CUDA (partial sums, then their fixed-order sum), counted as one in
    ``depthwise3x3x3_wgrad.launches``, C padded where it must be; the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return depthwise3x3x3_wgrad_plain(x, g)
    _check("depthwise3x3x3_wgrad", x, g, x.shape)
    return channel_padded(_launch_wgrad, x, g)


def _launch_wgrad(x, g):
    return _run_wgrad(x, g, plan_wgrad(tuple(x.shape), x.element_size()))


def _run_wgrad(x, g, p):
    """One call of the wgrad kernel on checked inputs with the plan ``p``."""
    fn = _function(load_library("depthwise3x3x3_wgrad"), "pmv_dw3x3x3_wgrad", 4, 15)
    c = x.shape[-1]
    partial = torch.empty((p.row_blocks, 27, c), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((3, 3, 3, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                 *x.shape, p.th, p.nv_log2, p.nseg, p.sw, p.pitch, p.gpitch,
                 p.tt, p.threads, p.smem_bytes, _DTYPES[x.dtype], stream)
    _raise_on(err, "depthwise3x3x3_wgrad")
    depthwise3x3x3_wgrad.launches += 1
    return dw


depthwise3x3x3_wgrad.launches = 0


def _aligned(t):
    """``t`` contiguous and 16-byte aligned, copied only when it is not."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class Depthwise3x3x3(torch.autograd.Function):
    """The JAX package's ``custom_vjp`` ``depthwise3x3x3`` (`:124-155`).

    On the card the channels are padded once a layer (``pad_channels``):
    the forward pads x and w and keeps them padded for the backward, which
    pads the cotangent once and runs dx and dw on the padded tensors; the
    output, dx and dw are sliced back to C."""

    @staticmethod
    def forward(ctx, x, w):
        c = x.shape[-1]
        if x.device.type == "cuda":
            _check("depthwise3x3x3", x, w, (3, 3, 3, c))
        if _pads(x):
            x, w = pad_channels(x), pad_channels(w)
        ctx.c = c
        ctx.save_for_backward(x, w)
        return sliced_channels(_conv(x, w), c)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        c = ctx.c
        g = _aligned(g)
        if _pads(x):
            g = pad_channels(g)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # A stride-1 SAME conv is its own transpose up to a kernel flip.
            w_flip = w.flip(0, 1, 2).contiguous()
            dx = sliced_channels(_conv(g, w_flip, "dx"), c).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = sliced_channels(_wgrad(x, g), c).to(w.dtype)
        return dx, dw


def depthwise3x3x3(x, w):
    """x [B, T, H, W, C], w [3, 3, 3, C] -> [B, T, H, W, C] in x.dtype,
    differentiable in x and w.

    Counts the launches of K1, forward and dx alike, in
    ``depthwise3x3x3.launches``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"depthwise3x3x3 runs on cpu or cuda, not {x.device}")
    return Depthwise3x3x3.apply(x, w)


depthwise3x3x3.launches = 0
