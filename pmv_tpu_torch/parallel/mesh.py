"""The (data, model) grid of temporal sequence parallelism
(TPU.SHARD_STRATEGY "dp_sp"), and its T collectives.

Counterpart of `pmv_tpu/parallel/mesh.py`. There ``create_mesh`` lays the
devices out as ``np.asarray(devices).reshape(shape)`` with a "model" axis
of 2 under dp_sp when the device count is even (``TPU.MESH_SHAPE`` and
``TPU.MESH_AXES`` when they are set), ``shard_batch`` cuts every rank-5
video tensor's T over "model", the parameters are replicated, and GSPMD adds
the halo exchanges of the convs and the all-gathers of K and V. Here the
same grid is made of process groups, and the model's modules call the
collectives themselves:

- Grid. Rank r of a world of W sits at (d, m) = (r // M, r % M) of a
  [W / M, M] grid (``grid``, ``layout_of``); an odd world under dp_sp runs
  as dp, as ``create_mesh`` lays a 1-D mesh then. Every rank of a model
  group (one data index d) holds the same rows of the global batch; rank m
  of it holds token planes [m T / M, (m + 1) T / M) of every activation,
  frames first (``Layout.planes``), and the cls token whole. A data group
  (one model index m) holds every row once: the rows of the global batch
  are split over it as over the world under dp.
- Groups. ``make_groups`` (``distributed.init_distributed`` calls it) makes
  one model group per data index, one data group per model index and
  MixUp's pair groups, (d, m) with (D - 1 - d, m), once for the job.
- ``sequence_parallel(layout)``: within it ``active()`` is the layout, and
  the modules run on this rank's T slice: a conv or pool with a T kernel
  above 1 extends its input by its halo planes (``extend_t``, from
  ``t_halo``) and pads T by 0 itself (``models/common.py``); MViT's
  attention gathers K's and V's tokens (``gather_t``) and offsets its
  temporal rel-pos table, UniFormer's global and temporal attention gather
  theirs, and so do the ResNet family's non-local blocks; every mean over
  T (the heads', SE's, AVSlowFast's AVS features) sums over the model
  group (``t_mean``, on ``all_reduce_model``); SlowFast's slow frames are
  every ALPHA-th of a rank's (``engine/steps.py::pack_pathways``), and
  AVSlowFast's audio, whole on every rank, is resized to the clip's slow T
  before a rank takes its planes of it; BatchNorm's statistics, over every
  rank's (rows, planes), are the global batch's already
  (``models/batchnorm.py``), and over rows that every rank of a model
  group holds whole (AVSlowFast's audio pathway) equal to one copy's.
- The collectives are ``torch.autograd.Function``s built from
  ``all_reduce`` alone, each rank adding its part to a buffer of zeros (so
  that they also run over gloo on CUDA tensors, two ranks sharing a card).
  Each backward sums over the model group: every rank computes the loss of
  its rows from the replicated cls token, so the model group's summed
  gradient is M times its rows' gradient, and DDP's mean over the W ranks
  gives the one-process gradient of the global batch.

``traffic`` counts the bytes each kind of T collective hands to
``all_reduce`` ("halo", "gather", "reduce"), forward and backward.
"""

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils.device import rank_and_world_size

logger = pmv_logging.get_logger(__name__)

DEFAULT_MODEL_SIZE = 2  # create_mesh's "model" axis under dp_sp

_groups = {}  # model size -> {"model", "data", "partner"}: this rank's groups
_active = None  # the Layout of the forward under way, or None
_logged_fallback = []
traffic = {"halo": 0, "gather": 0, "reduce": 0}


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in the grid: data index and size, model index and
    size (1 under dp and fsdp)."""

    data: int
    data_size: int
    model: int = 0
    model_size: int = 1

    @property
    def sequence_parallel(self):
        return self.model_size > 1

    def planes(self, t):
        """[start, stop) of the ``t`` planes (frames, or token planes) of a
        clip that this rank holds."""
        if t % self.model_size:
            raise ValueError(f"{t} planes do not split evenly over {self.model_size} ranks")
        n = t // self.model_size
        return self.model * n, (self.model + 1) * n


def model_size(cfg, world):
    """The size of the grid's "model" axis for ``cfg`` over ``world``
    processes: TPU.MESH_SHAPE's "model" entry where the mesh is given, else
    2 under dp_sp on an even world, else 1 (``create_mesh``'s rule)."""
    strategy = cfg.TPU.SHARD_STRATEGY
    if len(cfg.TPU.MESH_SHAPE):
        shape, axes = [int(s) for s in cfg.TPU.MESH_SHAPE], list(cfg.TPU.MESH_AXES)
        if int(np.prod(shape)) != world or len(axes) != len(shape):
            raise ValueError(f"TPU.MESH_SHAPE {shape} (axes {axes}) does not lay out "
                             f"{world} processes")
        size = shape[axes.index("model")] if "model" in axes else 1
    else:
        size = DEFAULT_MODEL_SIZE if strategy == "dp_sp" and world % 2 == 0 else 1
    if size > 1 and strategy != "dp_sp":
        raise NotImplementedError(
            f"a model axis of {size} under TPU.SHARD_STRATEGY {strategy}: temporal "
            "sequence parallelism runs under dp_sp")
    return size


def grid(world, size):
    """[world / size, size]: the rank at each (data, model) index, as
    ``np.asarray(devices).reshape(shape)`` places the devices."""
    return np.arange(world).reshape(world // size, size)


def layout_of(cfg, rank, world):
    size = model_size(cfg, world)
    return Layout(rank // size, world // size, rank % size, size)


def layout(cfg):
    """This process's ``Layout`` under ``cfg`` (its place in the job of
    ``torch.distributed``; (0, 1) outside one)."""
    rank, world = rank_and_world_size()
    lay = layout_of(cfg, rank, world)
    if cfg.TPU.SHARD_STRATEGY == "dp_sp" and not lay.sequence_parallel and not _logged_fallback:
        _logged_fallback.append(True)
        logger.info("TPU.SHARD_STRATEGY dp_sp on a world of %d runs as dp: the model axis "
                    "needs an even world", world)
    if lay.sequence_parallel and lay.model_size not in _groups:
        raise RuntimeError(f"the process groups of a model axis of {lay.model_size} were not "
                           "made: distributed.init_distributed(..., model_size=...)")
    return lay


def data_shard_count(cfg):
    """The size of the grid's "data" axis in this process's job."""
    return layout(cfg).data_size


def make_groups(rank, world, size, timeout):
    """This rank's model, data and pair groups for a model axis of ``size``
    (nothing when ``size`` is 1 or does not divide ``world``). Every rank
    calls it, with the same arguments but its rank."""
    if size <= 1 or world % size:
        return
    ranks = grid(world, size)
    d, m = divmod(rank, size)
    groups = {"data": None, "partner": None}
    for i, row in enumerate(ranks):  # every rank takes part in making each
        group = dist.new_group(row.tolist(), timeout=timeout)
        if i == d:
            groups["model"] = group
    n = ranks.shape[0]
    if n > 1:
        for j, col in enumerate(ranks.T):
            group = dist.new_group(col.tolist(), timeout=timeout)
            if j == m:
                groups["data"] = group
        if n == 2:  # the pair is the data group
            groups["partner"] = groups["data"]
        else:
            for j in range(size):
                for low in range(n // 2):
                    pair = [int(ranks[low, j]), int(ranks[n - 1 - low, j])]
                    group = dist.new_group(pair, timeout=timeout)
                    if rank in pair:
                        groups["partner"] = group
    _groups[size] = groups


def clear_groups():
    _groups.clear()


def group(lay, kind):
    """This rank's ``kind`` group ("model", "data", "partner") of the grid
    of ``lay``, which has a model axis; None where the data axis is 1."""
    return _groups[lay.model_size][kind]


# ----------------------------------------------------------------- the context


@contextlib.contextmanager
def sequence_parallel(lay):
    """Run the forwards within on this rank's T slice of ``lay`` (nothing
    changes for a layout without a model axis)."""
    global _active
    if not lay.sequence_parallel:
        yield
        return
    previous, _active = _active, lay
    try:
        yield
    finally:
        _active = previous


def active():
    """The layout of the sequence-parallel forward under way, or None."""
    return _active


def _required():
    if _active is None:
        raise RuntimeError("a T collective runs inside mesh.sequence_parallel(layout)")
    return _active


# ----------------------------------------------------------------- collectives


def _all_reduce(t, group, kind=None):
    """``t`` summed in place over ``group``, its bytes counted under
    ``kind`` in ``traffic`` (not counted when None)."""
    if kind is not None:
        traffic[kind] += t.numel() * t.element_size()
    dist.all_reduce(t, group=group)
    return t


class AllReduceSum(torch.autograd.Function):
    """The sum over ``group``'s ranks (None: every rank) of each rank's
    tensor; its gradient on a rank is the sum over the ranks of their
    gradients of the sum. ``kind`` names it in ``traffic`` (None: not
    counted)."""

    @staticmethod
    def forward(ctx, t, group=None, kind=None):
        ctx.group, ctx.kind = group, kind
        return _all_reduce(t.clone(memory_format=torch.contiguous_format), group, kind)

    @staticmethod
    def backward(ctx, grad):
        return AllReduceSum.apply(grad, ctx.group, ctx.kind), None, None


class _THalo(torch.autograd.Function):
    """(the ``left`` planes before this rank's first, the ``right`` planes
    after its last) of a T-sliced [B, t, ...] tensor, from the neighbour
    ranks of the model group; zeros beyond the clip's two ends. Slot r of
    the all-reduced buffer holds what rank r sends: its first ``right``
    planes (rank r - 1's right halo), then its last ``left`` (rank r + 1's
    left halo). The backward sends each halo plane's gradient back to the
    rank that owns the plane, the same way."""

    @staticmethod
    def forward(ctx, x, left, right, m, size, group):
        t = x.shape[1]
        ctx.meta = (left, right, m, size, group, t)
        buf = x.new_zeros((size, x.shape[0], right + left, *x.shape[2:]))
        buf[m, :, :right] = x[:, :right]
        buf[m, :, right:] = x[:, t - left:]
        _all_reduce(buf, group, "halo")
        lo = buf[m - 1, :, right:] if m > 0 else buf.new_zeros(buf[m, :, right:].shape)
        hi = buf[m + 1, :, :right] if m < size - 1 else buf.new_zeros(buf[m, :, :right].shape)
        return lo, hi

    @staticmethod
    def backward(ctx, g_lo, g_hi):
        left, right, m, size, group, t = ctx.meta
        buf = g_lo.new_zeros((size, g_lo.shape[0], right + left, *g_lo.shape[2:]))
        if m > 0:
            buf[m - 1, :, right:] = g_lo
        if m < size - 1:
            buf[m + 1, :, :right] = g_hi
        _all_reduce(buf, group, "halo")
        gx = buf.new_zeros((buf.shape[1], t, *buf.shape[3:]))
        gx[:, :right] += buf[m, :, :right]
        gx[:, t - left:] += buf[m, :, right:]
        return gx, None, None, None, None, None


def t_halo(x, left, right):
    """(the ``left`` planes before this rank's slice of [B, t, ...] ``x``,
    the ``right`` planes after it), from the model group's neighbours; zero
    planes at the clip's two ends. Differentiable."""
    lay = _required()
    t = x.shape[1]
    if left > t or right > t:
        raise ValueError(f"a halo of {left} + {right} planes from a neighbour's {t}")
    return _THalo.apply(x, left, right, lay.model, lay.model_size, group(lay, "model"))


def extend_t(x, left, right, fill=None):
    """[B, left + t + right, ...]: ``x`` between its halo planes
    (``t_halo``); beyond the clip's ends the planes are ``fill`` (zeros
    when None); ``x`` itself where both are 0."""
    lay = _required()
    if not (left or right):
        return x
    lo, hi = t_halo(x, left, right)
    if fill is not None:
        if lay.model == 0:
            lo = torch.full_like(lo, fill)
        if lay.model == lay.model_size - 1:
            hi = torch.full_like(hi, fill)
    return torch.cat([lo, x, hi], dim=1)


def gather_t(x):
    """[B, M t, ...]: the model group's [B, t, ...] slices of ``x``
    concatenated in T, in model order. Its backward is the model group's
    summed gradient of this rank's slot."""
    lay = _required()
    m, size = lay.model, lay.model_size
    buf = torch.cat([x.new_zeros((m,) + x.shape), x[None],
                     x.new_zeros((size - 1 - m,) + x.shape)])
    buf = AllReduceSum.apply(buf, group(lay, "model"), "gather")
    return buf.movedim(0, 1).flatten(1, 2)


def all_reduce_model(x):
    """The sum of ``x`` over the model group; its gradient the group's
    summed gradient."""
    return AllReduceSum.apply(x, group(_required(), "model"), "reduce")


def t_mean(x, dims, keepdim=False):
    """The mean of ``x`` over ``dims``, which hold axis 1, T. Inside
    ``sequence_parallel`` ``x`` is a rank's T slice: the rank's float32 sum
    over ``dims``, summed over the model group (``all_reduce_model``),
    divided by the clip's count, the rank's count times the model size
    (every rank holds as many planes), in x.dtype. Outside it
    ``x.mean(dims)``."""
    lay = _active
    if lay is None:
        return x.mean(dim=dims, keepdim=keepdim)
    count = lay.model_size * int(np.prod([x.shape[d] for d in dims]))
    total = all_reduce_model(x.to(torch.promote_types(x.dtype, torch.float32))
                             .sum(dim=dims, keepdim=keepdim))
    return (total / count).to(x.dtype)
