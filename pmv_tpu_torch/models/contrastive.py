"""Contrastive self-supervised models: MoCo, SimCLR, BYOL, SwAV and the
memory bank (`MViT/slowfast/models/contrastive.py`).

Counterpart of `pmv_tpu/models/contrastive.py`. ``ContrastiveModel``
(registered "ContrastiveModel") is the JAX package's ``ContrastiveEncoder``
(the backbone of MODEL.ARCH built headless, its features mean-pooled, the
``projection`` MLP, the output L2-normalised in float32 with + 1e-8) beside
the rest of the JAX package's ``SSLTrainState``, each a tensor of the
module, so that the ``.pyth`` checkpoint and auto-resume carry all of it:

- ``predictor`` (BYOL, ``PredictorMLP``) and ``prototypes`` (SwAV,
  [SWAV_QEUE_LEN or 256, DIM]) are parameters: the trainable tree is
  {online, predictor, prototypes}, as the JAX step's;
- ``momentum`` (MoCo and BYOL): the EMA encoder, a copy of the backbone's
  and the projection's parameters held as buffers under the same names, so
  that DDP takes none of them for its own. It has no BatchNorm statistics:
  ``encode_momentum`` runs the module with these tensors in place of its
  parameters, in eval mode, on the statistics it is given (the online
  encoder's from before the step, `ssl_steps.py:193-195, 244-248`). Under
  FSDP each is sharded as its online parameter (``sharded_buffers``), as
  the JAX package's ``param_sharding`` lays out the whole state: the EMA is
  a local update, and the key forward is FSDP's own, gathering the
  momentum weights block by block (``distributed.swapped``);
- ``queue`` [QUEUE_LEN, DIM] and ``queue_ptr`` (MoCo), ``bank`` [LENGTH,
  DIM] (TYPE "mem", or CONTRASTIVE.KNN_ON): buffers.

The losses and state updates are the JAX package's functions on tensors.
The cross-process parts of a step (SimCLR's gathered keys, Sinkhorn's sums
over the batch) come in as arguments, so that one process computes what the
JAX package computes. CONTRASTIVE.MOMENTUM_ANNEALING, MOCO_MULTI_VIEW_QUEUE,
SEQUENTIAL, BN_MLP, BN_SYNC_MLP, PREDICTOR_DEPTHS, LOCAL_SHUFFLE_BN,
SIMCLR_DIST_ON, INTERP_MEMORY and MEM_TYPE are read nowhere in the JAX
package, and nowhere here: the MLPs have no BatchNorm, and SwAV's
prototypes are not renormalised after a step (ROADMAP.md).
"""

import torch
import torch.nn.functional as F
from torch import nn

from pmv_tpu_torch.models.build import MODEL_REGISTRY
from pmv_tpu_torch.models.common import Linear, init_flax_defaults, init_weights
from pmv_tpu_torch.parallel import distributed

MOMENTUM_TYPES = ("moco", "byol")


class ProjectionMLP(nn.Module):
    """The SSL projection head, BN-free: ``fc0`` ... ``fc{n-1}``, ReLU
    between them (`contrastive.py:30-50`)."""

    def __init__(self, dim_in, dim, hidden, num_layers=2):
        super().__init__()
        widths = [dim_in] + [hidden] * (num_layers - 1) + [dim]
        for i in range(num_layers):
            setattr(self, f"fc{i}", Linear(widths[i], widths[i + 1]))
        self.num_layers = num_layers

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class PredictorMLP(ProjectionMLP):
    """BYOL's predictor: ``fc0`` to ``hidden``, ReLU, ``fc1`` to ``dim``."""

    def __init__(self, dim, hidden):
        super().__init__(dim, dim, hidden, num_layers=2)


def _backbone(cfg, dtype):
    """(the headless backbone of MODEL.ARCH, its feature width, the axes its
    features are mean-pooled over) (`contrastive.py:77-103`)."""
    arch = cfg.MODEL.ARCH
    if arch == "mvit":
        from pmv_tpu_torch.models.mvit import MViT

        net = MViT(cfg, dtype=dtype, head=False)
        return net, net.dim_out, (1,)
    if arch == "x3d":
        from pmv_tpu_torch.models.x3d import X3D

        net = X3D(cfg, dtype=dtype)
        width = net.head.conv_5.in_channels
    elif arch == "uniformer":
        from pmv_tpu_torch.models.uniformer import Uniformer

        net = Uniformer(cfg, dtype=dtype)
        width = net.head.in_features
    elif arch in ("slow", "c2d", "i3d", "2d"):
        from pmv_tpu_torch.models.resnet import ResNetModel

        net = ResNetModel(cfg, dtype=dtype)
        width = net.head.dim_in
    else:
        raise NotImplementedError(f"SSL backbone arch {arch}")
    del net.head  # built headless: return_features never reaches it
    return net, width, (1, 2, 3)


def _buffer_copy(named_tensors):
    """A module holding a detached copy of each (name, tensor) as a buffer
    under the same dotted name, in a tree of empty modules."""
    root = nn.Module()
    for name, t in named_tensors:
        *path, leaf = name.split(".")
        parent = root
        for part in path:
            if not hasattr(parent, part):
                parent.add_module(part, nn.Module())
            parent = getattr(parent, part)
        parent.register_buffer(leaf, t.detach().clone())
    return root


def l2_normalize(z):
    """z / (||z|| + 1e-8) in float32 (float64 for float64 z)."""
    z = z.to(torch.promote_types(z.dtype, torch.float32))
    return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)


class ContrastiveModel(nn.Module):
    """forward(x [B, T, H, W, 3]) -> z [B, DIM], L2-normalised, float32."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        c = cfg.CONTRASTIVE
        self.ssl_type = c.TYPE
        self.compute_dtype = dtype
        self.backbone, width, self.pool_dims = _backbone(cfg, dtype)
        self.projection = ProjectionMLP(width, c.DIM, c.MLP_DIM, max(c.NUM_MLP_LAYERS, 1))
        if c.TYPE == "byol":
            self.predictor = PredictorMLP(c.DIM, c.MLP_DIM)
        if c.TYPE == "swav":
            self.prototypes = nn.Parameter(torch.zeros(c.SWAV_QEUE_LEN or 256, c.DIM))
        if c.TYPE in MOMENTUM_TYPES:
            self.momentum = _buffer_copy(self.encoder_parameters())
        if c.TYPE == "moco":
            self.register_buffer("queue", torch.zeros(c.QUEUE_LEN, c.DIM))
            self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.int64))
        if c.TYPE == "mem" or c.KNN_ON:
            self.register_buffer("bank", torch.zeros(c.LENGTH, c.DIM))

    def encoder_parameters(self):
        """(name, parameter) of the online encoder: the backbone's and the
        projection's (the JAX state's ``params``)."""
        return [(n, p) for n, p in self.named_parameters()
                if n.startswith(("backbone.", "projection."))]

    def momentum_tensors(self):
        """The momentum encoder's tensors, in ``encoder_parameters``'s order."""
        return [self.get_buffer(n) for n, _ in self.sharded_buffers()]

    def replicated_parameters(self):
        """The parameters that stay whole on every rank under FSDP
        (``distributed.wrap_model``): SwAV's prototypes, which the loss reads
        outside the forward."""
        return [self.prototypes] if hasattr(self, "prototypes") else []

    def sharded_buffers(self):
        """(buffer name, parameter): each momentum tensor beside its online
        parameter, which it is laid out as under FSDP
        (``distributed.wrap_model``). The queue and the bank stay whole."""
        if not hasattr(self, "momentum"):
            return []
        return [("momentum." + n, p) for n, p in self.encoder_parameters()]

    def encoder_statistics(self):
        """{name: a copy} of the encoder's BatchNorm running statistics."""
        return {n: b.clone() for n, b in self.named_buffers()
                if n.startswith("backbone.") and "running" in n}

    @torch.no_grad()
    def init_weights(self, generator):
        """The backbone's own initializers (flax's defaults for the ResNet
        family and X3D), the projection truncated normal(0.02) with zero
        biases, the predictor flax's defaults, the prototypes normal(0.02)
        (`ssl_steps.py:35-56`); the momentum encoder a copy of the online
        one."""
        if hasattr(self.backbone, "init_weights"):
            self.backbone.init_weights(generator)
        else:
            init_weights(self.backbone, generator)
        init_weights(self.projection, generator)
        if hasattr(self, "predictor"):
            init_flax_defaults(self.predictor, generator)
        if hasattr(self, "prototypes"):
            self.prototypes.copy_(0.02 * torch.randn(self.prototypes.shape, generator=generator))
        if hasattr(self, "momentum"):
            for m, (_, p) in zip(self.momentum_tensors(), self.encoder_parameters()):
                m.copy_(p)

    def forward(self, x, **_):
        """The encoder on x, in the module's mode (BatchNorm's batch
        statistics, which move the running ones, in train mode)."""
        feats = self.backbone(x.to(self.compute_dtype), return_features=True)
        if isinstance(feats, tuple):  # MViT's (tokens, thw)
            feats = feats[0]
        return l2_normalize(self.projection(feats.mean(dim=self.pool_dims)))

    def encode_momentum(self, x, statistics):
        """The momentum encoder on x: eval mode, the BatchNorm running
        ``statistics`` given ({name: tensor}, ``encoder_statistics``), no
        gradient. The encoder's parameters and statistics hold the momentum
        tensors and ``statistics`` for the forward (``distributed.swapped``:
        under FSDP each block gathers its momentum weights as it gathers its
        online ones). A step calls it before the online forward and after
        the optimizer's, never while a graph holds the parameters."""
        tensors = [p for _, p in self.encoder_parameters()]
        tensors += [self.get_buffer(n) for n in statistics]
        values = self.momentum_tensors() + list(statistics.values())
        training = self.training
        self.eval()
        try:
            with torch.no_grad(), distributed.swapped(self, tensors, values):
                return self(x)
        finally:
            self.train(training)


@MODEL_REGISTRY.register(name="ContrastiveModel")
def build_contrastive(cfg, dtype=torch.float32):
    return ContrastiveModel(cfg, dtype=dtype)


# --------------------------------------------------------------------- losses


def moco_loss(q, k, queue, temperature):
    """InfoNCE with the queue's negatives (`contrastive.py:108-113`)."""
    l_pos = (q * k).sum(dim=-1, keepdim=True)
    l_neg = q @ queue.to(q.dtype).T
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    return -F.log_softmax(logits, dim=1)[:, 0].mean()


def simclr_loss(z1, z2, temperature, all_z1=None, all_z2=None, start=0):
    """NT-Xent over the global batch (`contrastive.py:116-127`): each of the
    2B rows against every other, the positive the row's other view. In a
    multi-process job ``z1``, ``z2`` are this rank's rows, starting at
    global row ``start``, and ``all_z1``, ``all_z2`` every rank's (gathered
    with their gradient); the loss is the mean over this rank's rows."""
    all_z1 = z1 if all_z1 is None else all_z1
    all_z2 = z2 if all_z2 is None else all_z2
    b, n = z1.shape[0], all_z1.shape[0]
    sim = torch.cat([z1, z2]) @ torch.cat([all_z1, all_z2]).T / temperature
    rows = torch.arange(b, device=z1.device) + start
    own = torch.cat([rows, rows + n])
    mask = torch.arange(2 * n, device=z1.device)[None, :] == own[:, None]
    sim = sim.masked_fill(mask, -1e9)
    targets = torch.cat([own[b:], own[:b]])
    return -F.log_softmax(sim, dim=1).gather(1, targets[:, None]).mean()


def byol_loss(p, z_target):
    """Normalised MSE (`contrastive.py:130-134`)."""
    p = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-8)
    z = z_target / (torch.linalg.vector_norm(z_target, dim=-1, keepdim=True) + 1e-8)
    return (2.0 - 2.0 * (p * z).sum(dim=-1)).mean()


def _local(t):
    return t


def sinkhorn(scores, n_iters=3, epsilon=0.05, reduce=_local):
    """SwAV's Sinkhorn-Knopp normalisation, a fixed count of iterations
    (`contrastive.py:137-146`). ``reduce`` sums a tensor over the ranks of
    a multi-process job (``distributed.all_reduce_sum``): the sums over the
    batch axis, the total and the batch size B are then the global
    batch's."""
    q = torch.exp(scores / epsilon).T  # [K, B]
    q = q / reduce(q.sum())
    k = q.shape[0]
    b = reduce(q.new_tensor(float(q.shape[1])))
    for _ in range(n_iters):
        q = q / reduce(q.sum(dim=1, keepdim=True)) / k
        q = q / q.sum(dim=0, keepdim=True) / b
    return (q * b).T


def swav_loss(z1, z2, prototypes, temperature, sinkhorn_iters=3, reduce=_local):
    """The swapped-prediction loss (`contrastive.py:150-161`); ``reduce`` as
    ``sinkhorn``'s."""
    protos = prototypes.to(z1.dtype)
    protos = protos / (torch.linalg.vector_norm(protos, dim=-1, keepdim=True) + 1e-8)
    s1, s2 = z1 @ protos.T, z2 @ protos.T
    with torch.no_grad():
        q1 = sinkhorn(s1.detach(), sinkhorn_iters, reduce=reduce)
        q2 = sinkhorn(s2.detach(), sinkhorn_iters, reduce=reduce)
    p1 = F.log_softmax(s1 / temperature, dim=1)
    p2 = F.log_softmax(s2 / temperature, dim=1)
    return -0.5 * ((q2 * p1).sum(dim=1) + (q1 * p2).sum(dim=1)).mean()


def mem_bank_loss(q, bank, indices, temperature):
    """Memory-bank NCE (TYPE "mem"): the positive of a row is the bank's row
    of its sample index (`contrastive.py:164-172`)."""
    bank = bank.to(q.dtype)
    l_pos = (q * bank[indices]).sum(dim=-1, keepdim=True)
    l_neg = q @ bank.T
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    return -F.log_softmax(logits, dim=1)[:, 0].mean()


# ------------------------------------------------------------- state updates


@torch.no_grad()
def ema_update(online, momentum_tensors, momentum):
    """m <- m * momentum + o * (1 - momentum), in place (`:176-180`); on each
    rank's shards where the tensors are sharded alike (no collective)."""
    online = [distributed.local(t) for t in online]
    momentum_tensors = [distributed.local(t) for t in momentum_tensors]
    torch._foreach_mul_(momentum_tensors, momentum)
    torch._foreach_add_(momentum_tensors, torch._foreach_mul(online, 1.0 - momentum))


@torch.no_grad()
def queue_update(queue, ptr, keys):
    """Ring-buffer enqueue of ``keys`` at ``ptr``, in place (`:183-189`)."""
    k = queue.shape[0]
    idx = torch.remainder(ptr + torch.arange(keys.shape[0], device=queue.device), k)
    queue.index_copy_(0, idx, keys.to(queue.dtype))
    ptr.copy_(torch.remainder(ptr + keys.shape[0], k))


@torch.no_grad()
def bank_update(bank, indices, feats, momentum=0.5):
    """The bank's rows ``indices`` moved towards ``feats`` by ``momentum``,
    then renormalised, in place (`:213-217`)."""
    new = bank[indices] * momentum + feats.to(bank.dtype) * (1 - momentum)
    new = new / (torch.linalg.vector_norm(new, dim=-1, keepdim=True) + 1e-8)
    bank.index_copy_(0, indices, new)


def knn_predict(bank, bank_labels, feats, num_classes, k=200, temperature=0.07):
    """kNN class scores from the bank (`contrastive.py:192-210`): the k most
    similar rows (the lower index first among equal similarities, as
    ``jax.lax.top_k``), each voting for its label with weight
    exp(similarity / temperature). A row past the end of ``bank_labels``
    votes with its last label, as the JAX package's gather clamps the index
    (ROADMAP.md); a label outside [0, num_classes) votes for none."""
    sim = feats @ bank.to(feats.dtype).T
    top = torch.sort(sim, dim=1, descending=True, stable=True)
    topv, topi = top.values[:, :k], top.indices[:, :k]
    weights = torch.exp(topv / temperature)
    labels = bank_labels.to(topi.device)[topi.clamp(max=bank_labels.shape[0] - 1)]
    votes = labels[..., None] == torch.arange(num_classes, device=labels.device)
    return (weights[..., None] * votes.to(weights.dtype)).sum(dim=1)
