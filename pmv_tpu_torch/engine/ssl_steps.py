"""Self-supervised train steps: the masked (MaskFeat) step.

Counterpart of `pmv_tpu/engine/ssl_steps.py:79-137` (``make_masked_train_step``,
``init_masked_state``). The step runs the JAX step's stages in its order:
uint8 clip -> preprocess (the train augmentation the config asks for; the
MaskFeat PT yaml's is normalisation alone) -> the mask: the loader's
(AUG.GEN_MASK_LOADER, the batch's "mask") where the batch has one, else the
model's own draw (``MaskMViT.sample_mask``) -> forward -> ``masked_loss``
-> backward -> the global grad norm -> clip and AdamW (``ChainOptimizer``:
SOLVER.CLIP_GRAD_L2NORM, 0.02 in the PT yaml) -> the NaN flag of the loss.

Its random draws (RandAugment, erasing, the mask, DropPath) come from
generators the step owns, seeded anew at every step from (``seed``, the
state's step count), as the supervised step's (``engine/steps.py``); or
from the caller, through ``draws``, which may also carry "hog_bins":
HOG's orientation bins to hold (``models.masked.hog_bins``), not a draw,
so that two sides can be compared on one side's bins. The contrastive
steps are not ported (ROADMAP.md).
"""

import torch

from pmv_tpu_torch.engine import steps
from pmv_tpu_torch.models import optimizer as optim
from pmv_tpu_torch.models.masked import masked_loss
from pmv_tpu_torch.utils.device import resolve_device

# A MaskMViT's state is the supervised one's: the step count, the model and
# its optimizer (`init_masked_state`, `ssl_steps.py:119-137`).
init_masked_state = steps.init_state


def make_masked_train_step(cfg, device=None, seed=0):
    """Returns train_step(state, batch, lr, draws=None) -> metrics.

    ``batch`` holds uint8 "frames" [B, T, H, W, 3] and, from a loader with
    AUG.GEN_MASK_LOADER, "mask" [B, n_tok] bool (arrays or tensors), moved to
    ``device`` (CUDA by default; raises without a CUDA device unless
    ``device="cpu"``), the device of ``state.model``, a MaskMViT. The step
    updates ``state`` in place and returns "loss", "grad_norm" (before
    clipping) and "nan" (the loss is not finite) as tensors on the device.
    ``train_step.sample_draws(model, shape, step)`` gives the draws of a
    step for a batch of ``shape``."""
    device = resolve_device(device)
    preprocess = steps.make_preprocess_fn(cfg, train=True, device=device)
    draw = steps.make_draw_sampler(preprocess, seed, device)

    def sample_draws(model, shape, given, step):
        return draw(shape, given, step, {
            "mask": lambda _, g: model.sample_mask(shape, g, device),
            "drop_path": lambda _, g: model.sample_drop_path_masks(shape[0], g, device),
        })

    def train_step(state, batch, lr, draws=None):
        model, optimizer = state.model, state.optimizer
        model.train()
        frames = torch.as_tensor(batch["frames"]).to(device, non_blocking=True)
        given = dict(draws or {})
        if batch.get("mask") is not None:  # the loader's mask comes first
            given["mask"] = batch["mask"]
        draws = sample_draws(model, tuple(frames.shape), given, state.step)
        mask = torch.as_tensor(draws["mask"]).to(device, non_blocking=True)

        x = preprocess(frames, draws)
        pred, target, mask = model(x, mask, drop_path_masks=draws["drop_path"],
                                   hog_bins=draws.get("hog_bins"))
        loss = masked_loss(pred, target, mask)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = optim.global_norm(
            p.grad if p.grad is not None else torch.zeros_like(p)
            for p in model.parameters()
        )
        optim.set_lr(optimizer, lr)
        optimizer.step(grad_norm=grad_norm)
        state.step += 1
        loss = loss.detach()
        return {"loss": loss, "grad_norm": grad_norm, "nan": ~torch.isfinite(loss)}

    train_step.sample_draws = (
        lambda model, shape, step=0: sample_draws(model, tuple(shape), {}, step)
    )
    return train_step
