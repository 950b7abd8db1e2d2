"""Precise BN: recompute the BatchNorm running statistics over batches of the
train loader (`MViT/tools/train_net.py:480-501`, fvcore's
``update_bn_stats``).

Counterpart of `pmv_tpu/engine/precise_bn.py`. The model runs in train mode
over ``min(BN.NUM_BATCHES_PRECISE, len(loader))`` batches, each through the
eval preprocessing, every row landscape (the ``pm`` flags are ignored, as
in the JAX package), under ``torch.no_grad()`` and ``frozen_stats``, so that
neither the running statistics nor ``num_batches_tracked`` move while it
runs. Each BatchNorm's batch mean and biased variance (float32) are
recorded and averaged over the batches with no momentum, and the averages
become its ``running_mean`` and ``running_var``.

The JAX package recovers each batch statistic from flax's momentum update,
``(new - 0.9 old) / 0.1``, which equals it up to ten times its float32
rounding; the port reads the batch statistics themselves.

The head's dropout gets an all-ones keep mask (it follows every BatchNorm,
so it cannot touch the statistics); drop-connect masks are drawn from a
generator seeded with 0 (the JAX package's ``PRNGKey(0)``), as train mode
drops paths there too.

AVSlowFast runs on the batch's "audio" (the JAX package's pass packs the
frames alone and fails: it passes no audio, `precise_bn.py:28`), without
the misaligned audio, as its eval does. Its DropPathway takes one decision
for the whole pass, from a host generator seeded with 0: the JAX package's
``stats_step`` applies the same ``PRNGKey(0)`` to every batch
(`precise_bn.py:30-33`), so its decision too is one for all batches, but
the two draws cannot give the same value.

In a multi-process job each rank runs its rows of the global batches: the
BatchNorms take the global batch statistics (``models/batchnorm.py``), and
the masks are drawn at the global batch's shape, each rank taking its rows,
so the statistics are those of the JAX package's pass over the global
batches. Under dp_sp (``parallel/mesh.py``) the rows are those of the
rank's data index, and each rank runs its frames of them inside
``mesh.sequence_parallel``, as the train step does: every rank's
(rows, planes) are its own, so the statistics are again the global
batch's (AVSlowFast's audio pathway, whole on every rank of a model
group, counts each row once a rank: the mean and biased variance of the
copies are one copy's).
"""

from itertools import islice

import torch

from pmv_tpu_torch.engine import steps
from pmv_tpu_torch.models.batchnorm import frozen_stats, recorded_stats
from pmv_tpu_torch.parallel import mesh
from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils.device import resolve_device

logger = pmv_logging.get_logger(__name__)


@torch.no_grad()
def calculate_and_update_precise_bn(loader, state, cfg, device=None):
    """Replace the running statistics of ``state.model``'s BatchNorms by
    their precise averages over ``loader``'s batches (any sized iterable of
    batches with uint8 "frames", and "audio" for AVSlowFast); returns ``state``, updated in place. Does
    nothing when the model has no BatchNorm."""
    model = state.model
    device = resolve_device(device)
    num_batches = min(cfg.BN.NUM_BATCHES_PRECISE, len(loader))
    with recorded_stats(model) as norms:
        if num_batches <= 0 or not norms:
            return state
        preprocess = steps.make_eval_preprocess_fn(cfg, device)
        generator = torch.Generator(device).manual_seed(0)
        kwargs = {}
        if hasattr(model, "sample_drop_pathway"):  # one decision for the pass
            kwargs["drop_pathway"] = model.sample_drop_pathway(torch.Generator().manual_seed(0))
        was_training = model.training
        model.train()
        count = 0
        lay = mesh.layout(cfg)
        rank, world = lay.data, lay.data_size
        with frozen_stats(model), mesh.sequence_parallel(lay):
            for batch in islice(loader, num_batches):
                frames = torch.as_tensor(batch["frames"]).to(device, non_blocking=True)
                x = steps.model_input(cfg, steps.local_frames(preprocess(frames), lay),
                                      steps.audio_of(batch, "audio", device))
                b = frames.shape[0]
                # The global batch's masks, this rank's rows of them.
                keep = model.sample_head_dropout_mask(b * world, generator, device)
                drop_path = steps.slice_rows(
                    model.sample_drop_path_masks(b * world, generator, device),
                    rank * b, (rank + 1) * b, b * world)
                model(x, drop_path_masks=drop_path,
                      head_dropout_mask=None if keep is None else torch.ones_like(keep[:b]),
                      **kwargs)
                count += 1
        model.train(was_training)
        if count == 0:
            return state
        for m in (m for m in norms if m.recorded):
            means, variances = zip(*m.recorded)
            m.running_mean.copy_(torch.stack(means).mean(dim=0))
            m.running_var.copy_(torch.stack(variances).mean(dim=0))
    logger.info("Updated precise BN stats over %d batches", count)
    return state
