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
collective runs.

``nn.BatchNorm3d`` puts the channels at axis 1 and moves ``running_var``
with the unbiased variance, and ``nn.SyncBatchNorm`` does the same, so
neither is used. The buffers keep
PyTorch's names (``running_mean``, ``running_var``, ``num_batches_tracked``),
so that the reference's checkpoints load by name.

``frozen_stats(model)`` holds every BatchNorm's running statistics still in
train mode (batch statistics still normalize): MODEL.FROZEN_BN, and the
transposed pass of a portrait train step. ``recorded_stats(model)`` keeps
every train-mode batch mean and variance each BatchNorm computes (precise
BN, ``engine/precise_bn.py``). ``get_norm(cfg)`` picks the norm by
BN.NORM_TYPE, as `pmv_tpu/models/batchnorm.py:102` does.
"""

import contextlib

import torch
from torch import nn

from pmv_tpu_torch.parallel.distributed import gather_rows
from pmv_tpu_torch.utils.device import rank_and_world_size


class BatchNorm(nn.Module):
    def __init__(self, dim, momentum=0.9, eps=1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.update_stats = True
        self.recorded = None  # a list while recorded_stats() is on
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            var, mean = torch.var_mean(xf, dim=tuple(range(x.dim() - 1)), correction=0)
            if rank_and_world_size()[1] > 1:
                mean, var = global_moments(mean, var, xf.numel() // xf.shape[-1])
            if self.recorded is not None:
                self.recorded.append((mean.detach(), var.detach()))
            if self.update_stats:
                with torch.no_grad():
                    for running, batch in ((self.running_mean, mean), (self.running_var, var)):
                        running.mul_(self.momentum).add_(batch, alpha=1.0 - self.momentum)
                    self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * scale + self.bias).to(x.dtype)


def global_moments(mean, var, count):
    """The mean and biased variance over every rank's rows, from this
    rank's (over ``count`` values a channel)."""
    stats = gather_rows(torch.stack([mean, var, torch.full_like(mean, count)]))
    means, variances, counts = stats.unbind(1)  # each [W, C]
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


def get_norm(cfg):
    """The norm constructor (``dim -> module``) of cfg.BN.NORM_TYPE.
    "batchnorm" and "sync_batchnorm" are the same module: the global
    batch's statistics in a multi-process job, as in the JAX package
    (`batchnorm.py:107-112`); "sub_batchnorm" is not ported."""
    norm_type = cfg.BN.NORM_TYPE
    if norm_type in ("batchnorm", "sync_batchnorm"):
        return BatchNorm
    if norm_type == "sub_batchnorm":
        raise NotImplementedError("BN.NORM_TYPE sub_batchnorm is not ported")
    raise NotImplementedError(f"Norm type {norm_type} is not supported")
