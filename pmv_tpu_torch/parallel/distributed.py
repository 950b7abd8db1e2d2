"""Multi-process jobs over ``torch.distributed``: one process per GPU.

Counterpart of `pmv_tpu/parallel/mesh.py`, which lays one JAX program over
every device of every host and lets XLA place the collectives, and of
PySlowFast's `utils/{multiprocessing,distributed}.py`, which that module
replaced (SURVEY.md section 2.5).

Layout. A job has NUM_SHARDS hosts ("shards") of NUM_GPUS processes each:
the world size is NUM_GPUS x NUM_SHARDS, and the process of local rank l on
shard s has rank s x NUM_GPUS + l and the device ``cuda:l`` (the CPU when the
job runs there). Each process takes TRAIN.BATCH_SIZE / NUM_GPUS rows of a
step, and rank r holds rows [r b, (r + 1) b) of the global batch, the batch
one process would take (``data/loader.py``). The JAX package runs one
program over that global batch; the port keeps its numbers: BatchNorm
statistics, MixUp's partner rows, the random draws, the portrait decision,
the loss, the grad norm and the metrics are those of the global batch
(``models/batchnorm.py``, ``engine/steps.py``); so are AVSlowFast's AVS
losses (their pair count summed over the ranks), its DropPathway decision
(drawn from the seed on every rank) and its easy-negative roll of the
misaligned audio (every rank's clips gathered; ``models/avslowfast.py``,
``steps.easy_negatives``).

Groups. The default group (NCCL on CUDA, gloo on the CPU; DIST_BACKEND
"ici", the JAX package's default, maps to those) carries the collectives on
device tensors: only ``all_reduce`` and ``broadcast``, so that they also run
over gloo on CUDA tensors (two ranks sharing one card). A gloo group carries
the host-side gathers of test results and flags, as PySlowFast's
``all_gather_unaligned`` has one. Each pair of ranks (r, W - 1 - r) has a
group of its own, which carries MixUp's exchange of rows. The groups are
made by ``init_distributed`` and dropped by ``destroy``, beside the process
group that ``torch.distributed`` keeps for the process.

Strategies (TPU.SHARD_STRATEGY). "dp" wraps the model in
``DistributedDataParallel``; "fsdp" shards its parameters with FSDP2's
``fully_shard``, per block and then the root. The JAX package's "fsdp" only
lays the parameters out otherwise (`mesh.py:125-137`), and so does this one:
both give dp's numbers; the SSL models' momentum encoder is laid out as
its online parameters are (``ContrastiveModel.sharded_buffers``), and SwAV's
prototypes stay whole, as the JAX package leaves a leaf of fewer than
65,536 elements replicated. "dp_sp" lays the ranks out as a (data, model)
grid and cuts every video activation of a classification model
(``SEQUENCE_PARALLEL_MODELS``) in T over the model axis
(``parallel/mesh.py``); the parameters are replicated and wrapped in
``DistributedDataParallel`` over the whole world. Under it the rows of the
global batch are split over a data group as over the world under dp
(``partner_rows`` and ``gather_rows`` take a layout for that), and the SSL
models raise NotImplementedError.
"""

import contextlib
import datetime

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from pmv_tpu_torch.parallel import mesh
from pmv_tpu_torch.utils.device import local_device, rank_and_world_size

# How long a collective waits for the other ranks before it raises.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)

_groups = {}  # "host": the gloo group; "partner": this rank's pair group


def world_size_of(cfg):
    return max(cfg.NUM_GPUS, 1) * max(cfg.NUM_SHARDS, 1)


def check_world(cfg):
    """Raise unless this process is one of NUM_GPUS x NUM_SHARDS: a config
    of more processes runs through ``launch_job``."""
    world = world_size_of(cfg)
    if rank_and_world_size()[1] != world:
        raise RuntimeError(
            f"NUM_GPUS x NUM_SHARDS = {world} processes, and this job has "
            f"{rank_and_world_size()[1]}: launch it with launch_job (run_net), or "
            "set NUM_GPUS 1 and NUM_SHARDS 1"
        )


def backend_of(cfg, device_type):
    """The process group's backend: DIST_BACKEND "nccl" or "gloo"; "ici"
    (the JAX package's default) is NCCL on CUDA, gloo on the CPU."""
    backend = cfg.DIST_BACKEND
    if backend == "ici":
        return "nccl" if device_type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"DIST_BACKEND {backend!r}: use nccl, gloo or ici")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("DIST_BACKEND nccl needs CUDA devices")
    return backend


def init_distributed(rank, world_size, init_method, device, backend, timeout=None,
                     model_size=1):
    """Join the process group as ``rank`` of ``world_size`` at
    ``init_method`` (``tcp://host:port``), with ``device`` as this process's
    device, and make the host and pair groups, and the groups of the dp_sp
    grid with a model axis of ``model_size`` (``mesh.model_size`` of the
    job's cfg) where it is above 1 and divides the world
    (``mesh.make_groups``). Every rank calls it."""
    timeout = timeout or DEFAULT_TIMEOUT
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    _groups["host"] = (dist.group.WORLD if backend == "gloo"
                       else dist.new_group(backend="gloo", timeout=timeout))
    for low in range(world_size // 2):
        pair = [low, world_size - 1 - low]
        group = dist.new_group(pair)  # every rank takes part in making each
        if rank in pair:
            _groups["partner"] = group
    mesh.make_groups(rank, world_size, model_size, timeout)


def destroy():
    """Leave the process group (a no-op outside one)."""
    _groups.clear()
    mesh.clear_groups()
    if dist.is_initialized():
        dist.destroy_process_group()


def launch_job(cfg, init_method, func, device):
    """Run ``func(cfg, device)`` in this process when the world size is 1;
    else ``func(cfg, its device)`` in NUM_GPUS processes on this shard, each
    of which first joins the process group (rank SHARD_ID x NUM_GPUS + its
    local rank, device ``cuda:<local rank>``, or the CPU when ``device`` is
    the CPU). Raises if a process fails."""
    device = torch.device(device)
    if world_size_of(cfg) == 1:
        func(cfg, device)
        return
    torch.multiprocessing.start_processes(
        _run_process, args=(cfg, init_method, func, device.type),
        nprocs=max(cfg.NUM_GPUS, 1), start_method="spawn",
    )


def _run_process(local_rank, cfg, init_method, func, device_type):
    device = local_device(local_rank, device_type)
    if device_type == "cpu":  # the host's cores, shared among its processes
        torch.set_num_threads(max(1, torch.get_num_threads() // max(cfg.NUM_GPUS, 1)))
    world = world_size_of(cfg)
    init_distributed(
        cfg.SHARD_ID * max(cfg.NUM_GPUS, 1) + local_rank, world,
        init_method, device, backend_of(cfg, device_type),
        model_size=mesh.model_size(cfg, world),
    )
    try:
        func(cfg, device)
    finally:
        destroy()


# ----------------------------------------------------------------- collectives


def all_reduce_sum(t):
    """The sum of ``t`` over the ranks (``t`` itself in a world of one)."""
    if rank_and_world_size()[1] == 1:
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t


def all_reduce_mean(t):
    """The mean of ``t`` over the ranks (``t`` itself in a world of one)."""
    return all_reduce_sum(t) / rank_and_world_size()[1]


def any_across_ranks(flag):
    """Whether ``flag`` (a bool) is set on any rank; host-side."""
    _, world = rank_and_world_size()
    if world == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_groups["host"])
    return bool(t.item())


def _data_axis(lay):
    """(this rank's index, the size, the group) of the data axis of ``lay``:
    the world under a layout without a model axis (or none given)."""
    if lay is None or not lay.sequence_parallel:
        return (*rank_and_world_size(), None)
    return lay.data, lay.data_size, mesh.group(lay, "data")


def gather_rows(t, lay=None):
    """[D, *t.shape]: every rank's ``t`` over the data axis of ``lay`` (the
    world when None), in order, with autograd: the gradient of a rank's slot
    is the sum of every rank's gradients of it. An all-reduce of zeros
    beside this rank's slot, so that it also runs over gloo on CUDA tensors;
    adding zeros changes no value."""
    rank, world, group = _data_axis(lay)
    if world == 1:
        return t[None]
    buf = torch.cat([t.new_zeros((rank,) + t.shape), t[None],
                     t.new_zeros((world - 1 - rank,) + t.shape)])
    return mesh.AllReduceSum.apply(buf, group)


def partner_rows(t, lay=None):
    """The ``t`` of data index D - 1 - d on data index d (of the same shape;
    the world's ranks when ``lay`` has no model axis): the rows that the
    global batch reversed puts here are these rows, reversed."""
    rank, world, _ = _data_axis(lay)
    partner = world - 1 - rank
    if partner == rank:
        return t
    low = min(rank, partner)
    buf = t.new_zeros((2,) + t.shape)
    buf[int(rank != low)] = t
    pair = mesh.group(lay, "partner") if lay is not None and lay.sequence_parallel else \
        _groups["partner"]
    dist.all_reduce(buf, group=pair)
    return buf[int(partner != low)]


def gather_host(arrays):
    """Each numpy array of ``arrays`` concatenated (axis 0) over the ranks,
    in rank order; the arrays may have any length on each rank."""
    _, world = rank_and_world_size()
    if world == 1:
        return [np.asarray(a) for a in arrays]
    gathered = [None] * world
    dist.all_gather_object(gathered, [np.asarray(a) for a in arrays],
                           group=_groups["host"])
    return [np.concatenate([g[i] for g in gathered]) for i in range(len(arrays))]


def barrier():
    """Wait for every rank (a no-op in a world of one)."""
    if rank_and_world_size()[1] > 1:
        dist.barrier(group=_groups["host"])


def lockstep(loader):
    """``(batch, real)`` for each of ``len(loader)`` steps, the same count
    on every rank. A rank whose shard ran out before the last step (an
    evaluation split whose size the global batch does not divide) gets its
    last batch again with ``real`` False: it runs the same forwards, and so
    the same collectives (FSDP's gathers), as the others, and drops what
    they give."""
    last = None
    it = iter(loader)
    for _ in range(len(loader)):
        batch = next(it, None)
        if batch is None:
            if last is None:
                raise ValueError("this rank's shard of the split is empty")
            yield last, False
        else:
            last = batch
            yield batch, True


# ------------------------------------------------------------------- wrapping


class Routed(nn.Module):
    """Holds the model, and runs ``route(model, *args, **kwargs)`` inside
    one call of itself: DDP expects one forward per backward, and a
    portrait step may run the model twice."""

    def __init__(self, model, replicated=()):
        super().__init__()
        self.model = model
        self.replicated = list(replicated)  # see average_replicated_grads

    def forward(self, route, *args, **kwargs):
        return route(self.model, *args, **kwargs)


def block_types():
    """The module classes that FSDP shards one by one: MViT's
    MultiScaleBlock (MaskMViT's backbone and decoder blocks too),
    UniFormer's CBlock, SABlock and SplitSABlock, the ResBlock of X3D and
    the ResNet family, and its Nonlocal blocks; the contrastive models'
    projection and predictor MLPs."""
    from pmv_tpu_torch.models.attention import MultiScaleBlock
    from pmv_tpu_torch.models.contrastive import ProjectionMLP
    from pmv_tpu_torch.models.nonlocal_block import Nonlocal
    from pmv_tpu_torch.models.resnet_helper import ResBlock
    from pmv_tpu_torch.models.uniformer import CBlock, SABlock, SplitSABlock

    return (MultiScaleBlock, CBlock, SABlock, SplitSABlock, ResBlock, Nonlocal, ProjectionMLP)


# The models that run under dp_sp (by MODEL.MODEL_NAME, and their classes'
# names): every classification model, MViT's, UniFormer, X3D, the ResNet
# family (C2D, I3D, Slow, non-local blocks), SlowFast, CSN, R(2+1)D and
# AVSlowFast; not the SSL models (ContrastiveModel, MaskMViT).
SEQUENCE_PARALLEL_MODELS = ("MViT", "Uniformer", "Uniformerframe", "X3D", "ResNet",
                            "ResNetModel", "SlowFast", "CSN", "PTVCSN", "R2Plus1D",
                            "PTVR2plus1D", "SeparatedConvNet", "AVSlowFast")


def _refuse_model(name):
    if name not in SEQUENCE_PARALLEL_MODELS:
        raise NotImplementedError(
            f"TPU.SHARD_STRATEGY dp_sp takes the classification models; {name} under "
            "dp_sp is queued in ROADMAP.md")


def refuse_sequence_parallel(cfg):
    """Raise for what a multi-process dp_sp job of ``cfg`` asks for and the
    port does not run under it: an SSL model (``SEQUENCE_PARALLEL_MODELS``
    lists the others), detection, feature extraction, multigrid."""
    if cfg.TPU.SHARD_STRATEGY != "dp_sp" or world_size_of(cfg) == 1:
        return
    _refuse_model(cfg.MODEL.MODEL_NAME)
    asked = [name for name, on in (
        ("DETECTION.ENABLE", cfg.DETECTION.ENABLE), ("TEST.FEAT_EXTRACT", cfg.TEST.FEAT_EXTRACT),
        ("MULTIGRID", cfg.MULTIGRID.LONG_CYCLE or cfg.MULTIGRID.SHORT_CYCLE)) if on]
    if asked:
        raise NotImplementedError(f"{', '.join(asked)} under TPU.SHARD_STRATEGY dp_sp: "
                                  "queued in ROADMAP.md")


def wrap_model(model, strategy, device):
    """The module a train step calls (``Routed``): under "dp" the model in
    ``DistributedDataParallel`` (buffers not broadcast: every rank moves its
    BatchNorm statistics by the same global batch statistics); under "fsdp"
    the model with its parameters sharded by ``fully_shard``, block by
    block, then the root. Under "fsdp" a model may also name
    ``replicated_parameters()``, which stay whole on every rank
    (``average_replicated_grads`` averages their gradients), and
    ``sharded_buffers()``, (buffer name, parameter) pairs, each buffer then
    laid out as its parameter's shards are. Under "dp_sp" (a model of
    ``SEQUENCE_PARALLEL_MODELS``; the SSL models and a detection model
    raise) as under "dp", over the whole world, since the parameters are
    replicated over the grid. ``model`` stays the module that holds the
    parameters (FSDP's are sharded ``DTensor``s); its parameter and buffer
    names do not change."""
    if strategy == "dp_sp":
        _refuse_model(type(model).__name__)
        if getattr(model, "detection", False):
            raise NotImplementedError("DETECTION.ENABLE under TPU.SHARD_STRATEGY dp_sp: "
                                      "queued in ROADMAP.md")
        strategy = "dp"
    if strategy == "dp":
        return nn.parallel.DistributedDataParallel(
            Routed(model), device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False,
        )
    if strategy == "fsdp":
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        world = rank_and_world_size()[1]
        mesh = init_device_mesh(device.type, (world,))
        replicated = list(getattr(model, "replicated_parameters", tuple)())
        for module in [m for m in model.modules() if isinstance(m, block_types())]:
            fully_shard(module, mesh=mesh)
        fully_shard(model, mesh=mesh,
                    **({"ignored_params": set(replicated)} if replicated else {}))
        for name, p in getattr(model, "sharded_buffers", tuple)():
            owner, _, leaf = name.rpartition(".")
            model.get_submodule(owner).register_buffer(
                leaf, shard_like(model.get_buffer(name), p))
        return Routed(model, replicated if world > 1 else ())
    raise ValueError(f"TPU.SHARD_STRATEGY {strategy!r}: use dp, fsdp or dp_sp")


def average_replicated_grads(wrapped):
    """The mean over the ranks of the gradients of the parameters that
    ``wrap_model`` left whole under FSDP (``wrapped.replicated``), as DDP
    averages every gradient; nothing for another ``wrapped`` (DDP's, or
    None)."""
    for p in getattr(wrapped, "replicated", ()):
        if p.grad is not None:
            p.grad.copy_(all_reduce_mean(p.grad))


def _reshard(model):
    """Every FSDP module of ``model`` back to its shards: a module that FSDP
    left gathered after a forward (the root does, until its backward)
    gathers its shards again at its next forward."""
    from torch.distributed.fsdp import FSDPModule

    for m in model.modules():
        if isinstance(m, FSDPModule):
            m.reshard()


@contextlib.contextmanager
@torch.no_grad()
def swapped(model, tensors, values):
    """Inside the block, ``tensors`` (parameters or buffers of ``model``)
    hold ``values`` (laid out alike), copied in place; after it, their own
    values again. Under FSDP the copies are of each rank's shards, and every
    FSDP module of ``model`` is resharded before and after: a forward inside
    the block gathers ``values`` block by block, as it gathers the
    parameters, and never the whole model at once. Run no backward through
    a graph that holds ``tensors`` across the block."""
    tensors = [local(t) for t in tensors]
    saved = [t.clone() for t in tensors]
    _reshard(model)  # no module holds its own gathered tensors ...
    torch._foreach_copy_(tensors, [local(v) for v in values])
    try:
        yield
    finally:
        _reshard(model)  # ... nor gathered values
        torch._foreach_copy_(tensors, saved)


def local(t):
    """This rank's shard of ``t`` (a sharded ``DTensor``), else ``t``. In-place
    updates of the shard update ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def full(t):
    """The whole of ``t``: a sharded ``DTensor`` gathered (a collective:
    every rank calls it, in the same order), else ``t``."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def shard_like(value, like):
    """``value`` (the whole tensor, on any device) laid out as ``like``: a
    ``DTensor`` sharded as ``like`` is, cut locally (no collective), when
    ``like`` is one; else ``value`` itself."""
    if not isinstance(like, DTensor):
        return value
    return distribute_tensor(value.to(local(like).device), like.device_mesh,
                             like.placements, src_data_rank=None)


def is_sharded(t):
    return isinstance(t, DTensor)
