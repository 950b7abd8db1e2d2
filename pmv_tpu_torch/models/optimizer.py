"""Optimizer construction (`MViT/slowfast/models/optimizer.py`).

Counterpart of `pmv_tpu/models/optimizer.py`, whose optax chain is written
here as one ``torch.optim.Optimizer``, ``ChainOptimizer``, with the same
update, in the same order:

1. clip: by value (SOLVER.CLIP_GRAD_VAL), else by the global norm
   (SOLVER.CLIP_GRAD_L2NORM) as optax's ``clip_by_global_norm`` does:
   ``g / norm * max_norm`` only when ``norm >= max_norm``
   (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm instead);
2. "sgd": masked weight decay added to the gradient, then momentum (optax
   ``trace``, Nesterov or not, no dampening); "adam", "adamw",
   "mt_adamw": Adam's moments and bias correction, then the masked weight
   decay added to the Adam update;
3. the layer-decay scale (SOLVER.LAYER_DECAY < 1), per parameter;
4. for SGD with SOLVER.LARS_ON, the trust ratio ||p|| / ||update||;
5. the step, ``p += -lr * update``.

Parameter groups carry what optax carries as masks: ``decay`` (the weight
decay mask, ``make_wd_mask``) and ``lr_scale`` (``make_layer_decay_scales``).
The learning rate is set per iteration with ``set_lr``.

Under FSDP (``parallel/distributed.py``) the parameters, their gradients and
the optimizer's state are sharded ``DTensor``s: every stage but the norms
works on each rank's shards, updating them in place, and the norms (the
global grad norm, LARS's trust ratio) sum their squares over every shard.
"""

import numpy as np
import torch

from pmv_tpu_torch.parallel import distributed
from pmv_tpu_torch.utils import lr_policy


def get_epoch_lr(cur_epoch, cfg):
    """LR at a fractional epoch (`optimizer.py` get_epoch_lr)."""
    return lr_policy.get_lr_at_epoch(cfg, cur_epoch)


def _is_bn_param(names):
    joined = "/".join(names).lower()
    module = names[-2].lower() if len(names) > 1 else names[0].lower()
    return (
        "batchnorm" in joined
        or "bn" in module
        or "batch_stats" in joined
        or any(seg.endswith("_bn") or seg == "bn" for seg in joined.split("/"))
    )


_NO_DECAY_NAMES = (
    "pos_embed",
    "pos_embed_spatial",
    "pos_embed_temporal",
    "pos_embed_class",
    "rel_pos_h",
    "rel_pos_w",
    "rel_pos_t",
    "cls_token",
)


def make_wd_mask(model, cfg):
    """{parameter name: True where weight decay applies}."""

    def decide(name, p):
        names = name.split(".")
        if cfg.MVIT.ZERO_DECAY_POS_CLS and any(n in name for n in _NO_DECAY_NAMES):
            return False
        if cfg.SOLVER.ZERO_WD_1D_PARAM and (p.dim() <= 1 or names[-1] == "bias"):
            return False
        if _is_bn_param(names):
            # BN params use BN.WEIGHT_DECAY (0.0 by default).
            return cfg.BN.WEIGHT_DECAY > 0.0
        return True

    return {name: decide(name, p) for name, p in model.named_parameters()}


def make_layer_decay_scales(model, cfg):
    """{parameter name: LAYER_DECAY ** (num_layers - layer_id)}
    (`optimizer.py:151-200` get_param_groups): MViT's block i, also under a
    prefix (MaskMViT's ``backbone.blocks.i``), is layer i + 1; the tokens,
    position tables (the decoder's too) and patch embedding layer 0; the
    rest (the head, the decoder's blocks) the last layer."""
    decay = cfg.SOLVER.LAYER_DECAY
    num_layers = cfg.MVIT.DEPTH + 1

    def layer_id(name):
        if any(n in name for n in ("cls_token", "pos_embed", "patch_embed")):
            return 0
        parts = name.split(".")
        for part, index in zip(parts, parts[1:]):
            if part == "blocks":
                return int(index) + 1
        return num_layers

    return {
        name: decay ** (num_layers - layer_id(name))
        for name, _ in model.named_parameters()
    }


def global_norm(tensors):
    """sqrt of the sum of squares over all ``tensors`` (optax global_norm),
    as the norm of the per-tensor norms; over every shard of the sharded
    ones; float32, or float64 for float64 tensors. On the CPU each tensor's
    norm sums in float64: PyTorch's CPU float32 norm sums in order, and
    read MaskFeat's float32 gradients' norm 1.6e-5 to 2.0e-5 low, where the
    card's lies within 3e-7 of float64's (PERF.md, ``tools/op_witness.py``)."""
    tensors = list(tensors)
    local = [distributed.local(t) for t in tensors]
    dtype = torch.promote_types(local[0].dtype, torch.float32) if local else torch.float32
    if local and local[0].device.type == "cpu":
        norms = torch.stack(torch._foreach_norm([t.double() for t in local])).to(dtype)
    else:
        norms = torch.stack(torch._foreach_norm([t.to(dtype) for t in local]))
    sharded = [distributed.is_sharded(t) for t in tensors]
    if not any(sharded):
        return torch.linalg.vector_norm(norms)
    sharded = torch.tensor(sharded, device=norms.device)
    squares = norms.square()
    total = distributed.all_reduce_sum(torch.where(sharded, squares, 0.0).sum())
    return (total + torch.where(sharded, 0.0, squares).sum()).sqrt()


class ChainOptimizer(torch.optim.Optimizer):
    """The JAX package's optax chain as one optimizer (see the module
    docstring). ``step(grad_norm=None)`` takes the global gradient norm when
    the caller has it already; a parameter without a gradient steps as if
    its gradient were zero, as in JAX.

    Each stage runs on a group's tensors at once (``torch._foreach_*``), so
    a step launches tens of kernels, not several per parameter."""

    def __init__(self, param_groups, method, lr, betas=(0.9, 0.999), eps=1e-8,
                 momentum=0.9, nesterov=True, clip_grad_val=None,
                 clip_grad_l2norm=None, lars=False):
        if method not in ("sgd", "adam", "adamw", "mt_adamw"):
            raise NotImplementedError(f"Optimizer {method} not supported")
        # "count": the group's steps taken, for Adam's bias correction (kept
        # in the groups, so that state_dict carries it).
        defaults = dict(lr=lr, weight_decay=0.0, decay=True, lr_scale=1.0, count=0)
        super().__init__(param_groups, defaults)
        self.method = method
        self.betas = tuple(betas)
        self.eps = eps
        self.momentum = momentum
        self.nesterov = nesterov
        self.clip_grad_val = clip_grad_val
        self.clip_grad_l2norm = clip_grad_l2norm
        self.lars = lars and method == "sgd"

    @torch.no_grad()
    def step(self, closure=None, grad_norm=None):
        if closure is not None:
            raise ValueError("ChainOptimizer takes no closure")
        groups = [
            (group, [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in group["params"]])
            for group in self.param_groups
        ]
        local = distributed.local
        if self.clip_grad_l2norm is not None and self.clip_grad_val is None:
            if grad_norm is None:
                grad_norm = global_norm(g for _, grads in groups for g in grads)
            # g / norm * max_norm where norm >= max_norm, else g unchanged.
            keep = grad_norm < self.clip_grad_l2norm
            divisor = torch.where(keep, torch.ones_like(grad_norm), grad_norm)
            factor = torch.where(keep, 1.0, self.clip_grad_l2norm).to(grad_norm)
        for group, grads in groups:
            grads = [local(g) for g in grads]
            if self.clip_grad_val is not None:
                v = self.clip_grad_val
                grads = torch._foreach_clamp_max(torch._foreach_clamp_min(grads, -v), v)
            elif self.clip_grad_l2norm is not None:
                grads = torch._foreach_mul(torch._foreach_div(grads, divisor), factor)
            params = group["params"]
            group["count"] += 1
            wd = group["weight_decay"] if group["decay"] else None
            if self.method == "sgd":
                updates = self._sgd(params, grads, wd)
            else:
                updates = self._adam(params, grads, wd, group["count"])
            if group["lr_scale"] != 1.0:  # not in place: SGD's updates may be its traces
                updates = torch._foreach_mul(updates, group["lr_scale"])
            if self.lars:
                updates = [u * _trust_ratio(p, u) for p, u in zip(params, updates)]
            torch._foreach_add_([local(p) for p in params],
                                torch._foreach_mul(updates, -group["lr"]))

    def _state(self, params, key, first=None):
        """This rank's shards of the state ``key`` of each of ``params``,
        updated in place; made (a ``DTensor`` where the parameter is one)
        equal to ``first``'s tensors, else zeros, at the first step."""
        for i, p in enumerate(params):
            if key not in self.state[p]:
                self.state[p][key] = torch.zeros_like(p)
                if first is not None:
                    distributed.local(self.state[p][key]).copy_(first[i])
        return [distributed.local(self.state[p][key]) for p in params]

    def _sgd(self, params, grads, wd):
        """Masked weight decay into the gradient, then optax ``trace``."""
        local_params = [distributed.local(p) for p in params]
        updates = grads if wd is None else torch._foreach_add(
            grads, torch._foreach_mul(local_params, wd))
        started = "trace" in self.state[params[0]]
        traces = self._state(params, "trace", first=updates)
        if started:
            torch._foreach_mul_(traces, self.momentum)
            torch._foreach_add_(traces, updates)
        if self.nesterov:
            return torch._foreach_add(updates, torch._foreach_mul(traces, self.momentum))
        return traces

    def _adam(self, params, grads, wd, count):
        """optax ``scale_by_adam``, then the masked weight decay."""
        b1, b2 = self.betas
        mus, nus = self._state(params, "mu"), self._state(params, "nu")
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        mu_hat = torch._foreach_div(mus, _bias_correction(b1, count))
        nu_hat = torch._foreach_div(nus, _bias_correction(b2, count))
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        if wd is not None:
            updates = torch._foreach_add(
                updates, torch._foreach_mul([distributed.local(p) for p in params], wd))
        return updates


def _bias_correction(decay, count):
    """1 - decay ** count, in float32 as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _trust_ratio(p, u):
    """optax scale_by_trust_ratio: ||p|| / ||u||, 1 where either is 0, in
    ``u``'s dtype. ``u`` is this rank's shard of the update of ``p``. The
    norms sum in float64 on every device: PyTorch's CPU float32 norm sums
    in order and read Slow R50's weights' norms up to 2.6e-4 off float64's,
    the card's within 8e-8 (``tools/f64_witness.py``, PERF.md), and moved
    the LARS updates by 1.2e-5 to 2.8e-5, card against CPU."""
    sharded = distributed.is_sharded(p)

    def norm(t):
        n = torch.linalg.vector_norm(t, dtype=torch.float64)
        return distributed.all_reduce_sum(n.square()).sqrt() if sharded else n

    p_norm = norm(distributed.local(p))
    u_norm = norm(u)
    ratio = (p_norm / u_norm).to(u.dtype)
    return torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(ratio), ratio)


def construct_optimizer(model, cfg):
    """The ChainOptimizer of SOLVER.OPTIMIZING_METHOD over ``model``'s
    parameters, grouped by weight-decay mask and layer-decay scale; the LR
    starts at SOLVER.BASE_LR."""
    wd_mask = make_wd_mask(model, cfg)
    scales = (
        make_layer_decay_scales(model, cfg)
        if cfg.SOLVER.LAYER_DECAY < 1.0 else {}
    )
    groups = {}
    for name, p in model.named_parameters():
        key = (wd_mask[name], scales.get(name, 1.0))
        groups.setdefault(key, []).append(p)
    param_groups = [
        dict(params=params, decay=decay, lr_scale=scale,
             weight_decay=cfg.SOLVER.WEIGHT_DECAY)
        for (decay, scale), params in groups.items()
    ]
    return ChainOptimizer(
        param_groups,
        method=cfg.SOLVER.OPTIMIZING_METHOD,
        lr=cfg.SOLVER.BASE_LR,
        betas=cfg.SOLVER.BETAS,
        momentum=cfg.SOLVER.MOMENTUM,
        nesterov=cfg.SOLVER.NESTEROV,
        clip_grad_val=cfg.SOLVER.CLIP_GRAD_VAL,
        clip_grad_l2norm=cfg.SOLVER.CLIP_GRAD_L2NORM,
        lars=cfg.SOLVER.LARS_ON,
    )


def set_lr(optimizer, new_lr):
    """Set the learning rate of every parameter group (reference `set_lr`)."""
    for group in optimizer.param_groups:
        group["lr"] = new_lr
