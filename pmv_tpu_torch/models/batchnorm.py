"""BatchNorm on channels-last tensors, as flax ``nn.BatchNorm`` computes it.

The counterpart of the JAX package's ``nn.BatchNorm(momentum=0.9,
epsilon=1e-5)`` (`pmv_tpu/models/uniformer.py:22-26, 382-385`):

- the channels are the last axis; the statistics run over every other axis,
  in float32 (float64 for a float64 input), and the output comes back in
  the input's dtype;
- train mode normalizes with the batch's mean and **biased** variance, and
  moves the running statistics by ``running = 0.9 * running + 0.1 * batch``
  with that same biased variance; eval mode normalizes with the running
  statistics.

In a ``torch.distributed`` job of more than one process the batch
statistics are those of the global batch, every rank's rows, under
BN.NORM_TYPE "batchnorm" as under "sync_batchnorm", as in the JAX package,
whose one program sees the global batch (`pmv_tpu/models/batchnorm.py:104-112`;
PySlowFast's plain BatchNorm takes each GPU's own): each rank's mean and
biased variance (float32) and its count go to every rank in one all-reduce
with autograd (``parallel.distributed.gather_rows``), and combine as
``mean = sum n_i m_i / N``, ``var = sum n_i (v_i + (m_i - mean)^2) / N``.
The backward all-reduces their gradients in turn. In a world of one no
collective runs. Under TPU.SHARD_STRATEGY dp_sp (``parallel/mesh.py``)
the rows are a data group's: inside ``mesh.sequence_parallel`` every rank
holds its planes of its rows, and the moments combine over the world;
inside ``mesh.whole_rows`` (the contrastive views, whole on every rank of a
model group) over the data group, whose ranks hold every row once
(``_moments_axis``).

``nn.BatchNorm3d`` puts the channels at axis 1 and moves ``running_var``
with the unbiased variance, and ``nn.SyncBatchNorm`` does the same, so
neither is used. The buffers keep
PyTorch's names (``running_mean``, ``running_var``, ``num_batches_tracked``),
so that the reference's checkpoints load by name.

Eval mode reads the running statistics in the input's float type: a
float64 input is normalized in float64 throughout, as in training.

SubBatchNorm (BN.NORM_TYPE "sub_batchnorm", `pmv_tpu/models/batchnorm.py:
43-99`, the reference's SubBatchNorm3d) is this module with ``num_splits``
S >= 1: the affine is shared; train mode takes the statistics within S
contiguous splits of the batch (of the global batch in a multi-process job,
whose splits may lie inside a rank or span ranks: each split's moments
combine over the ranks as ``global_moments`` does), and moves running
statistics of S x C values, split after split; eval mode aggregates them
on the fly: the mean of the split means, and the variance by the law of
total variance. A batch the splits do not divide raises, as the JAX
package asserts. The multigrid long cycle changes a model's BatchNorm type
between epochs (``utils/multigrid.py``): ``swap_norms(model, cfg)`` turns
every norm that ``get_norm`` made into the kind of cfg's BN.NORM_TYPE in
place, its statistics converted as the JAX package's
``adapt_state_across_bn`` converts them (`pmv_tpu/utils/checkpoint.py:
269-322`), and keeps the module objects and their parameters, so that the
optimizer's state and a DDP or FSDP wrapper stay as they were.

``frozen_stats(model)`` holds every BatchNorm's running statistics still in
train mode (batch statistics still normalize): MODEL.FROZEN_BN, and the
transposed pass of a portrait train step. ``recorded_stats(model)`` keeps
every train-mode batch mean and variance each BatchNorm computes (precise
BN, ``engine/precise_bn.py``; S x C values under splits). ``get_norm(cfg)``
picks the norm by BN.NORM_TYPE, as `pmv_tpu/models/batchnorm.py:102` does.
"""

import contextlib
import functools

import torch
from torch import nn

from pmv_tpu_torch.parallel import mesh
from pmv_tpu_torch.parallel.distributed import gather_rows
from pmv_tpu_torch.utils.device import rank_and_world_size


class BatchNorm(nn.Module):
    """BatchNorm over every axis but the last; with ``num_splits`` S >= 1 a
    SubBatchNorm of S splits (module docstring). ``follows_norm_type`` marks
    a norm that ``get_norm`` made, which ``swap_norms`` turns."""

    def __init__(self, dim, momentum=0.9, eps=1e-5, num_splits=0, follows_norm_type=False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.num_splits = num_splits
        self.follows_norm_type = follows_norm_type
        self.update_stats = True
        self.recorded = None  # a list while recorded_stats() is on
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(max(num_splits, 1) * dim))
        self.register_buffer("running_var", torch.ones(max(num_splits, 1) * dim))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.num_splits:
            return self._split_forward(x, xf)
        if self.training:
            var, mean = torch.var_mean(xf, dim=tuple(range(x.dim() - 1)), correction=0)
            if rank_and_world_size()[1] > 1:
                mean, var = global_moments(mean, var, xf.numel() // xf.shape[-1],
                                           _moments_axis()[2])
            self._track(mean, var)
        else:
            mean, var = self.running_mean.to(xf.dtype), self.running_var.to(xf.dtype)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * scale + self.bias).to(x.dtype)

    def _track(self, mean, var):
        """Record and move the running statistics by a train-mode batch's."""
        if self.recorded is not None:
            self.recorded.append((mean.detach(), var.detach()))
        if self.update_stats:
            with torch.no_grad():
                for running, batch in ((self.running_mean, mean), (self.running_var, var)):
                    running.mul_(self.momentum).add_(batch, alpha=1.0 - self.momentum)
                self.num_batches_tracked += 1

    def _split_forward(self, x, xf):
        """SubBatchNorm: split statistics in train mode, their aggregate in
        eval mode; the affine after the normalized value's cast to the
        input's dtype, as the JAX module applies it."""
        s, c = self.num_splits, x.shape[-1]
        if self.training:
            mean, var = split_moments(xf, s)  # [S, C] each
            self._track(mean.reshape(-1), var.reshape(-1))
            rank, world, _ = _moments_axis()
            b = x.shape[0]
            split = (torch.arange(b, device=x.device) + rank * b) // (b * world // s)
            shape = (b,) + (1,) * (x.dim() - 2) + (c,)
            mean, var = mean[split].reshape(shape), var[split].reshape(shape)
        else:
            m = self.running_mean.to(xf.dtype).reshape(s, c)
            v = self.running_var.to(xf.dtype).reshape(s, c)
            mean = m.mean(dim=0)
            var = (v + m.square()).mean(dim=0) - mean.square()
        out = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        return (out * self.weight + self.bias).to(x.dtype)

    @torch.no_grad()
    def set_splits(self, num_splits):
        """Turn this norm into a SubBatchNorm of ``num_splits`` splits (0: a
        plain BatchNorm) in place, its running statistics converted as the
        JAX package's ``adapt_state_across_bn``: from fewer values to more,
        tiled; from more to fewer, the mean over the groups they fold into
        (the variance too: a plain mean, not the law of total variance of
        the module's eval); of equal count, unchanged."""
        for name in ("running_mean", "running_var"):
            old = getattr(self, name)
            size = max(num_splits, 1) * self.weight.shape[0]
            if size > old.numel():
                new = old.repeat(size // old.numel())
            elif size < old.numel():
                new = old.reshape(old.numel() // size, size).mean(dim=0)
            else:
                new = old
            self.register_buffer(name, new.clone())
        self.num_splits = num_splits


def _moments_axis():
    """(this rank's index among the holders of the global batch's rows, their
    count, the layout whose data group combines the moments: None for the
    world). Under dp_sp the rows go by data index: inside
    ``mesh.sequence_parallel`` the world combines them, each rank's planes
    of its rows a share of the batch; inside ``mesh.whole_rows`` the data
    group, whose ranks hold every row once."""
    lay = mesh.active()
    if lay is not None:
        return lay.data, lay.data_size, None
    lay = mesh.rows()
    if lay is not None:
        return lay.data, lay.data_size, lay
    return (*rank_and_world_size(), None)


def global_moments(mean, var, count, lay=None):
    """The mean and biased variance over every rank's rows, from this
    rank's (over ``count`` values a channel), combined over the data axis
    of ``lay`` (the world when None)."""
    stats = gather_rows(torch.stack([mean, var, torch.full_like(mean, count)]), lay)
    means, variances, counts = stats.unbind(1)  # each [W, C]
    total = counts.sum(0)
    g_mean = (counts * means).sum(0) / total
    g_var = (counts * (variances + (means - g_mean).square())).sum(0) / total
    return g_mean, g_var


def split_moments(xf, num_splits):
    """The mean and biased variance [S, C] of each of ``num_splits``
    contiguous splits of the global batch, from this rank's rows
    [r b, (r + 1) b) of it (r its data index under dp_sp). In a
    multi-process job each rank takes the moments of its rows of each split
    (none where it holds no row of it), and they combine over the ranks as
    ``global_moments``'s (``_moments_axis``)."""
    rank, world, lay = _moments_axis()
    b, c = xf.shape[0], xf.shape[-1]
    if b * world % num_splits:
        raise ValueError(f"batch {b * world} not divisible by num_splits {num_splits}")
    n = b * world // num_splits  # rows a split
    if rank_and_world_size()[1] == 1:
        var, mean = torch.var_mean(xf.reshape(num_splits, -1, c), dim=1, correction=0)
        return mean, var
    per_row = xf[0].numel() // c
    means, variances, counts = [], [], []
    for j in range(num_splits):
        lo, hi = max(j * n - rank * b, 0), min((j + 1) * n - rank * b, b)
        if hi > lo:
            var, mean = torch.var_mean(xf[lo:hi].reshape(-1, c), dim=0, correction=0)
        else:
            var = mean = xf.new_zeros(c)
        means.append(mean)
        variances.append(var)
        counts.append(xf.new_full((c,), max(hi - lo, 0) * per_row))
    stats = gather_rows(torch.stack([torch.stack(means), torch.stack(variances),
                                     torch.stack(counts)]), lay)  # [W, 3, S, C]
    means, variances, counts = stats.unbind(1)
    total = counts.sum(0)
    g_mean = (counts * means).sum(0) / total
    g_var = (counts * (variances + (means - g_mean).square())).sum(0) / total
    return g_mean, g_var


def has_batchnorm(model):
    return any(isinstance(m, BatchNorm) for m in model.modules())


@contextlib.contextmanager
def frozen_stats(model, frozen=True):
    """Within the block, the BatchNorms of ``model`` leave their running
    statistics as they are (when ``frozen``)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    before = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = not frozen and m.update_stats
    try:
        yield
    finally:
        for m, update in zip(norms, before):
            m.update_stats = update


@contextlib.contextmanager
def recorded_stats(model):
    """Within the block, each train-mode forward of a BatchNorm of ``model``
    appends its batch (mean, biased variance), float32, to that module's
    ``recorded`` list. Yields the BatchNorms, in module order."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.recorded = []
    try:
        yield norms
    finally:
        for m in norms:
            m.recorded = None


def norm_splits(cfg):
    """The ``num_splits`` of cfg's BN.NORM_TYPE: BN.NUM_SPLITS for
    "sub_batchnorm", 0 for "batchnorm" and "sync_batchnorm"."""
    norm_type = cfg.BN.NORM_TYPE
    if norm_type in ("batchnorm", "sync_batchnorm"):
        return 0
    if norm_type == "sub_batchnorm":
        return cfg.BN.NUM_SPLITS
    raise NotImplementedError(f"Norm type {norm_type} is not supported")


def norm_name(cfg):
    """BN.NORM_TYPE, with its splits for "sub_batchnorm"."""
    splits = norm_splits(cfg)
    return f"{cfg.BN.NORM_TYPE} ({splits} splits)" if splits else cfg.BN.NORM_TYPE


def get_norm(cfg):
    """The norm constructor (``dim -> module``) of cfg.BN.NORM_TYPE.
    "batchnorm" and "sync_batchnorm" are the same module: the global
    batch's statistics in a multi-process job, as in the JAX package
    (`batchnorm.py:107-112`); "sub_batchnorm" a SubBatchNorm of
    BN.NUM_SPLITS splits of the global batch."""
    return functools.partial(BatchNorm, num_splits=norm_splits(cfg), follows_norm_type=True)


def swap_norms(model, cfg):
    """Turn every norm of ``model`` that ``get_norm`` made into the kind of
    cfg's BN.NORM_TYPE, in place (``BatchNorm.set_splits``); the others (the
    stems', the non-local blocks') stay. Returns the count turned."""
    splits = norm_splits(cfg)
    turned = 0
    for m in model.modules():
        if isinstance(m, BatchNorm) and m.follows_norm_type and m.num_splits != splits:
            m.set_splits(splits)
            turned += 1
    return turned
