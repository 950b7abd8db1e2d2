"""Self-supervised train steps: the masked (MaskFeat) step and the
contrastive steps (MoCo, SimCLR, BYOL, SwAV, memory bank).

Counterpart of `pmv_tpu/engine/ssl_steps.py`. Each step returns "loss",
"grad_norm" (global, before any clip) and "nan" (the loss is not finite)
as tensors on the device, so that ``engine.train.train_epoch`` drives
them as it drives the supervised step.

The masked step (`:79-137`) runs the JAX step's stages in its order: uint8
clip -> preprocess (the train augmentation the config asks for; the
MaskFeat PT yaml's is normalisation alone) -> the mask: the loader's
(AUG.GEN_MASK_LOADER, the batch's "mask") where the batch has one, else the
model's own draw (``MaskMViT.sample_mask``) -> forward -> ``masked_loss``
-> backward -> the global grad norm -> clip and AdamW (``ChainOptimizer``:
SOLVER.CLIP_GRAD_L2NORM, 0.02 in the PT yaml) -> the NaN flag of the loss.

The contrastive step (`:140-278`): two views of each clip (a 5-D batch
augmented twice; a 6-D [B, V, T, H, W, C] batch of the loader's views takes
views 0 and 1 % V, so that views 2 and 3 of TRAIN_CROP_NUM_TEMPORAL 4 are
decoded and dropped, as in the JAX package), each through its own draws of
the train preprocessing (the SSL colour jitter of the recipes among them;
in float32, or float64 for a model of float64 activations); then by
CONTRASTIVE.TYPE:

- moco: z1 = the online encoder on view 1 in train mode; the key z2 = the
  momentum encoder on view 2 in eval mode, on the online encoder's
  BatchNorm statistics from before the step (it has none of its own);
  InfoNCE against the queue;
- simclr, swav: both views through the online encoder in train mode, one
  after the other, the second on the statistics the first left; NT-Xent,
  or the swapped prediction against the prototypes (Sinkhorn, 3 fixed
  iterations);
- byol: the predictor on z1 against the momentum encoder's z2 (as MoCo's);
- mem: z1 against the bank's rows.

Then the backward over the trainable tensors {online encoder, predictor,
prototypes}, the global grad norm and the optimizer (SGD, LARS in the
SimCLR, BYOL and SwAV yamls); the EMA of the momentum encoder with the
fixed CONTRASTIVE.MOMENTUM (moco, byol); the queue filled from a third
forward, view 2 through the *updated* momentum encoder on the old
statistics (moco); and, where the model has a bank (TYPE "mem" or
CONTRASTIVE.KNN_ON), the bank's rows of the batch's "index" moved towards
the online z1 by CONTRASTIVE.MOMENTUM.

Draws come from generators the step owns, seeded anew at every step from
(``seed``, the state's step count[, the view]), as the supervised step's
(``engine/steps.py``); or from the caller, through ``draws``. The masked
step's may also carry "hog_bins": HOG's orientation bins to hold
(``models.masked.hog_bins``), not a draw, so that two sides can be compared
on one side's bins; the contrastive step's are {"view1": ..., "view2": ...},
each a dict of the preprocessing's draws.

In a multi-process job (TPU.SHARD_STRATEGY "dp" or "fsdp"; the state's
``wrapped`` is the model under DDP, or sharded by FSDP2) a rank's step
gives the JAX step's numbers on the global batch, of which rank r holds
rows [r b, (r + 1) b): the draws are made at the global batch's shape and
each rank takes its rows; DDP or FSDP averages the gradients (SwAV's
prototypes, whole on every rank under FSDP as in the JAX package's
``param_sharding``, by an all-reduce of their own). Under FSDP the
momentum encoder's tensors are sharded as their online parameters, so the
EMA is a local update, and its key forward gathers them block by block as
FSDP gathers the online encoder's (``ContrastiveModel.encode_momentum``);
the grad norm and LARS's trust ratios sum over every shard
(``models/optimizer.py``). SimCLR takes its logits of the local rows against
every rank's z of both views, gathered with their gradient (the gather's
backward sums over the ranks); Sinkhorn's sums over the batch, its total
and its B are the global batch's; the queue takes every rank's keys and the
bank every rank's (index, z1), in rank order, so that they stay the same
on every rank; MaskFeat's loss divides by the global count of masked
tokens. The loss reported is the global batch's.

Under TPU.SHARD_STRATEGY dp_sp (``parallel/mesh.py``) the rows above are a
data group's, which every rank of a model group holds alike, and the
gathers, the sums and the queue's and bank's rows run over the data group
(``distributed.gather_rows``, ``all_reduce_sum`` with the layout). The
masked step draws and preprocesses the whole clip, then each rank keeps its
frames, its token planes of the mask (the loader's or the model's draw)
and of the HOG bins, and runs the forward inside
``mesh.sequence_parallel``: the ranks hold disjoint (rows, planes), so the
masked-token count sums over the world, and each rank's share of the loss,
times the world, averages under DDP to the global loss. The contrastive
views stay whole on every rank (rank 6, as the JAX package's
``shard_batch`` leaves them), with no sequence-parallel forward; their
BatchNorm moments combine over the data group (``mesh.whole_rows``).
"""

import torch

from pmv_tpu_torch.engine import steps
from pmv_tpu_torch.models import contrastive as cm
from pmv_tpu_torch.models import optimizer as optim
from pmv_tpu_torch.models.masked import masked_loss
from pmv_tpu_torch.parallel import distributed, mesh
from pmv_tpu_torch.utils.device import rank_and_world_size, resolve_device

# A MaskMViT's state is the supervised one's: the step count, the model and
# its optimizer (`init_masked_state`, `ssl_steps.py:119-137`). So is a
# ContrastiveModel's: its SSL state lives on the module (its momentum
# encoder, queue, bank, predictor and prototypes), its trainable tensors
# are its parameters (`init_ssl_state`, `:35-76`).
init_masked_state = init_ssl_state = steps.init_state

CONTRASTIVE_TYPES = ("moco", "simclr", "byol", "swav", "mem")
VIEWS = ("view1", "view2")


def _call(model, *args, **kwargs):
    """A route for ``state.wrapped``: the model's one forward."""
    return model(*args, **kwargs)


def _gathered(t, lay=None):
    """Every rank's ``t`` over the data axis of ``lay`` (the world when
    None), concatenated in rank order along the first axis, with autograd
    (``distributed.gather_rows``)."""
    return distributed.gather_rows(t, lay).flatten(0, 1)


def local_token_planes(mask, t_tok, lay):
    """This rank's token planes ([B, n_tok] -> [B, n_tok / M], t-major) of a
    clip's mask of ``t_tok`` token planes under the sequence parallelism of
    ``lay``; ``mask`` itself without it."""
    if not lay.sequence_parallel:
        return mask
    start, stop = lay.planes(t_tok)
    return mask.reshape(mask.shape[0], t_tok, -1)[:, start:stop].reshape(mask.shape[0], -1)


def _grad_norm(model):
    return optim.global_norm(p.grad if p.grad is not None else torch.zeros_like(p)
                             for p in model.parameters())


def make_masked_train_step(cfg, device=None, seed=0):
    """Returns train_step(state, batch, lr, draws=None) -> metrics.

    ``batch`` holds uint8 "frames" [B, T, H, W, 3] and, from a loader with
    AUG.GEN_MASK_LOADER, "mask" [B, n_tok] bool (arrays or tensors), moved to
    ``device`` (CUDA by default; raises without a CUDA device unless
    ``device="cpu"``), the device of ``state.model``, a MaskMViT. The step
    updates ``state`` in place and returns "loss", "grad_norm" (before
    clipping) and "nan" (the loss is not finite) as tensors on the device.
    In a multi-process job the batch is this rank's rows (under dp_sp its
    data index's whole clips), and ``draws`` (and their "hog_bins") those
    of the global batch's whole clips.
    ``train_step.sample_draws(model, shape, step)`` gives the draws of a
    step for a batch of ``shape``."""
    device = resolve_device(device)
    preprocess = steps.make_preprocess_fn(cfg, train=True, device=device)
    draw = steps.make_draw_sampler(preprocess, seed, device)

    def sample_draws(model, shape, given, step):
        return draw(shape, given, step, {
            "mask": lambda _, g: model.sample_mask(shape, g, device),
            "drop_path": lambda _, g: model.sample_drop_path_masks(shape[0], g, device),
            "dropout_masks": lambda _, g: model.sample_dropout_masks(shape, g, device),
        })

    def train_step(state, batch, lr, draws=None):
        model, optimizer = state.model, state.optimizer
        model.train()
        frames = torch.as_tensor(batch["frames"]).to(device, non_blocking=True)
        lay = mesh.layout(cfg)
        rank, world = lay.data, lay.data_size
        b = frames.shape[0]
        shape = (b * world, *frames.shape[1:])
        given = dict(draws or {})
        loader_mask = batch.get("mask")
        if loader_mask is not None:  # the loader's mask comes first: draw none
            given["mask"] = None
        draws = steps.local_draws(sample_draws(model, shape, given, state.step),
                                  rank * b, (rank + 1) * b, shape[0])
        mask = loader_mask if loader_mask is not None else draws["mask"]
        mask = local_token_planes(torch.as_tensor(mask).to(device, non_blocking=True),
                                  model.token_grid(shape)[0], lay)
        hog_bins = draws.get("hog_bins")
        if hog_bins is not None:
            hog_bins = steps.local_frames(torch.as_tensor(hog_bins), lay)

        x = steps.local_frames(preprocess(frames, draws), lay)
        # The backbone's dropout masks are the clips' rows here, and its
        # forward takes the rank's token planes of them (mesh.local_planes).
        kwargs = dict(drop_path_masks=draws["drop_path"], hog_bins=hog_bins,
                      dropout_masks=draws["dropout_masks"])
        with mesh.sequence_parallel(lay):
            if state.wrapped is None:
                pred, target, mask = model(x, mask, **kwargs)
            else:
                pred, target, mask = state.wrapped(_call, x, mask, **kwargs)
        # This rank's share of the global loss, times the world: DDP
        # averages the ranks' gradients (under dp_sp the ranks hold
        # disjoint planes, and the count sums over all of them).
        count = distributed.all_reduce_sum(mask.sum())
        loss = masked_loss(pred, target, mask, count) * rank_and_world_size()[1]
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        distributed.finish_grads(state.wrapped)  # FSDP under a model axis
        grad_norm = _grad_norm(model)
        optim.set_lr(optimizer, lr)
        optimizer.step(grad_norm=grad_norm)
        state.step += 1
        loss = distributed.all_reduce_mean(loss.detach())
        return {"loss": loss, "grad_norm": grad_norm, "nan": ~torch.isfinite(loss)}

    train_step.sample_draws = (
        lambda model, shape, step=0: sample_draws(model, tuple(shape), {}, step)
    )
    return train_step


def make_ssl_train_step(cfg, device=None, seed=0):
    """Returns train_step(state, batch, lr, draws=None) -> metrics, the
    contrastive step of CONTRASTIVE.TYPE (the module docstring).

    ``batch`` holds uint8 "frames" [B, T, H, W, 3] or [B, V, T, H, W, 3] and
    int "index" [B] (arrays or tensors), moved to ``device`` (CUDA by
    default; raises without a CUDA device unless ``device="cpu"``), the
    device of ``state.model``, a ContrastiveModel. The step updates
    ``state`` (the model's parameters and SSL buffers, the optimizer) in
    place. ``train_step.sample_draws(shape, step)`` gives the draws of a
    step for one view of ``shape`` [B, T, H, W, 3]."""
    device = resolve_device(device)
    ssl_type = cfg.CONTRASTIVE.TYPE
    if ssl_type not in CONTRASTIVE_TYPES:
        raise NotImplementedError(f"CONTRASTIVE.TYPE {ssl_type}")
    temperature = cfg.CONTRASTIVE.T
    mom = cfg.CONTRASTIVE.MOMENTUM
    preprocess = steps.make_preprocess_fn(cfg, train=True, device=device)
    draw = steps.make_draw_sampler(preprocess, seed, device)

    def sample_draws(shape, given, step):
        """Each view's draws, from generators of its own."""
        return {view: draw(shape, given.get(view, {}), (step, i), {})
                for i, view in enumerate(VIEWS)}

    def losses(model, view1, view2, index, z2, start, lay):
        """(the loss of this rank's rows, z1): the online forwards."""
        z1 = model(view1)
        if ssl_type == "moco":
            loss = cm.moco_loss(z1, z2, model.queue, temperature)
        elif ssl_type == "simclr":
            z2 = model(view2)
            loss = cm.simclr_loss(z1, z2, temperature, _gathered(z1, lay), _gathered(z2, lay),
                                  start)
        elif ssl_type == "byol":
            loss = cm.byol_loss(model.predictor(z1), z2)
        elif ssl_type == "swav":
            z2 = model(view2)
            loss = cm.swav_loss(z1, z2, model.prototypes, temperature,
                                reduce=lambda t: distributed.all_reduce_sum(t, lay))
        else:  # mem
            loss = cm.mem_bank_loss(z1, model.bank, index, temperature)
        return loss, z1

    def train_step(state, batch, lr, draws=None):
        model, optimizer = state.model, state.optimizer
        model.train()
        frames = torch.as_tensor(batch["frames"]).to(device, non_blocking=True)
        index = torch.as_tensor(batch["index"]).to(device, non_blocking=True)
        if frames.dim() == 6:
            f1, f2 = frames[:, 0], frames[:, 1 % frames.shape[1]]
        else:
            f1 = f2 = frames
        lay = mesh.layout(cfg)
        rank, world = lay.data, lay.data_size
        b = f1.shape[0]
        shape = (b * world, *f1.shape[1:])
        draws = sample_draws(shape, draws or {}, state.step)
        dtype = torch.promote_types(model.compute_dtype, torch.float32)
        view1, view2 = (preprocess(f, steps.local_draws(draws[view], rank * b,
                                                        (rank + 1) * b, shape[0]), dtype)
                        for f, view in zip((f1, f2), VIEWS))

        statistics = z2 = None
        if ssl_type in cm.MOMENTUM_TYPES:
            statistics = model.encoder_statistics()  # before the step moves them
            z2 = model.encode_momentum(view2, statistics)
        args = (view1, view2, index, z2, rank * b, lay)
        with mesh.whole_rows(lay):  # the views: every rank of a model group the same
            if state.wrapped is None:
                loss, z1 = losses(model, *args)
            else:
                loss, z1 = state.wrapped(losses, *args)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        distributed.finish_grads(state.wrapped)  # FSDP's whole prototypes, a model axis
        grad_norm = _grad_norm(model)
        optim.set_lr(optimizer, lr)
        optimizer.step(grad_norm=grad_norm)
        state.step += 1

        if ssl_type in cm.MOMENTUM_TYPES:
            cm.ema_update([p for _, p in model.encoder_parameters()],
                          model.momentum_tensors(), mom)
        if ssl_type == "moco":
            keys = model.encode_momentum(view2, statistics)
            cm.queue_update(model.queue, model.queue_ptr, _gathered(keys, lay))
        if hasattr(model, "bank"):
            with torch.no_grad():
                cm.bank_update(model.bank, _gathered(index, lay), _gathered(z1.detach(), lay),
                               mom)
        loss = distributed.all_reduce_mean(loss.detach(), lay)
        return {"loss": loss, "grad_norm": grad_norm, "nan": ~torch.isfinite(loss)}

    train_step.sample_draws = (
        lambda shape, step=0: sample_draws(tuple(shape), {}, step)
    )
    return train_step


def make_ssl_feature_step(cfg, model, device=None):
    """feature_step(frames) -> the eval-mode z of uint8 frames [B, T, H, W,
    3], L2-normalised again as the bank's rows are (`:140-154`), for the kNN
    monitor."""
    device = resolve_device(device)
    preprocess = steps.make_eval_preprocess_fn(cfg, device)

    @torch.inference_mode()
    def feature_step(frames):
        model.eval()
        frames = torch.as_tensor(frames).to(device, non_blocking=True)
        return cm.l2_normalize(model(preprocess(frames)))

    return feature_step
