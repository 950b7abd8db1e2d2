"""Per-block recompute in MViT (MODEL.ACT_CHECKPOINT, TPU.REMAT_MIN_SEQ), and
MVIT.DROPOUT_RATE in MaskFeat pre-training, against the JAX package.

Tiny MViT: 4 frames of 16^2, width 8, 4 blocks, MixUp/CutMix without
RandAugment and erasing, block 0's stride-1 3x3x3
q-pool on K1's plain version, block 1's q stride (1, 2, 2): blocks 0 and 1
see 2 x 4 x 4 = 32 tokens, blocks 2 and 3 see 8. TPU.REMAT_MIN_SEQ 20 splits
them. float32 on the CPU.

- (a) The port's two train steps under ACT_CHECKPOINT equal its steps
  without it to 1e-6: loss, grad norm and every parameter.
- (b) Under ACT_CHECKPOINT, and under REMAT_MIN_SEQ 20, with DropPath and
  MVIT.DROPOUT_RATE at 0.1, two steps against the jitted JAX
  ``make_train_step`` with the same knob, the port fed JAX's draws and the
  keep masks its "dropout" key draws (read off a JAX model without the knob:
  a mask depends on the key, the module's path and the shape, and
  ``nn.remat`` keeps the paths): loss and grad norm to rtol 1e-5,
  parameters to atol 1e-5 after the two AdamW steps (as
  tests/test_torch_port_dropout_pool_first.py holds them).
- (c) A forward pre-hook counts 2 calls a train step for each rematted
  block (its forward, then the recompute) and 1 for the others; that set is
  the JAX rule (`pmv_tpu/models/mvit.py:275-278`) on the grids of
  ``_compute_mvit_schedule``. Eval and no-grad forwards recompute nothing.
- (d) The bytes autograd saves for the backward (counted under
  ``torch.autograd.graph.saved_tensors_hooks``) fall with each knob.
- (e) MaskMViT's backbone: tests/test_torch_port_remat_maskfeat.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_train as mvit_train
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models.common import DropPath
from pmv_tpu.models.mvit import _compute_mvit_schedule
from pmv_tpu_torch.engine.steps import init_state, make_train_step
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.utils.weights import load_jax_params
from test_torch_port_dropout_pool_first import LRS, _assert_params, _jax_state
from torch_port_util import (  # noqa: F401
    depthwise_calls,
    jax_dropout_key,
    jax_dropout_masks_fn,
    jax_train_draws,
    port_cfg,
)

MIN_SEQ = 20  # between blocks 2-3's 8 tokens and blocks 0-1's 32
KNOBS = {"act_checkpoint": ("MODEL.ACT_CHECKPOINT", True),
         "remat_min_seq": ("TPU.REMAT_MIN_SEQ", MIN_SEQ)}


def remat_cfg(knob=None, dropout=0.0):
    """Tiny MViT of 4 blocks with the recompute ``knob`` (a key of KNOBS)
    set, DropPath and MVIT.DROPOUT_RATE at ``dropout``."""
    cfg = mvit_train._train_cfg()
    cfg.AUG.ENABLE = False  # MixUp/CutMix stay: tests/test_torch_port_train.py holds the rest
    cfg.MVIT.DEPTH = 4
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 1, 1], [3, 1, 1, 1]]
    cfg.MVIT.DROPPATH_RATE = dropout
    cfg.MVIT.DROPOUT_RATE = dropout
    if knob is not None:
        cfg.merge_from_list(list(KNOBS[knob]))
    return cfg


def jax_rematted(cfg):
    """The blocks the JAX MViT remats in a train apply of ``cfg``'s clip:
    its rule (`mvit.py:275-278`) on the grids of ``_compute_mvit_schedule``,
    the q-pool's output grid recomputed as `mvit.py:333-340` does."""
    thw = (cfg.DATA.NUM_FRAMES // cfg.MVIT.PATCH_STRIDE[0],
           cfg.DATA.TRAIN_CROP_SIZE // cfg.MVIT.PATCH_STRIDE[1],
           cfg.DATA.TRAIN_CROP_SIZE // cfg.MVIT.PATCH_STRIDE[2])
    out = set()
    for i, spec in enumerate(_compute_mvit_schedule(cfg)):
        if cfg.MODEL.ACT_CHECKPOINT or (
                cfg.TPU.REMAT_MIN_SEQ > 0 and int(np.prod(thw)) >= cfg.TPU.REMAT_MIN_SEQ):
            out.add(i)
        kq, sq = spec["kernel_q"], spec["stride_q"]
        if len(kq) > 0 and (np.prod(kq) > 1 or np.prod(sq) > 1):
            thw = tuple((n + 2 * (k // 2) - k) // s + 1 for n, k, s in zip(thw, kq, sq))
    return out


def jax_mvit_drop_path_masks(masks_fn, variables, key, model):
    """The DropPath keep masks the JAX MViT draws in a train apply under
    ``key`` (``masks_fn``: ``jax_dropout_masks_fn`` of its DropPath),
    laid out as the port ``model``'s ``sample_drop_path_masks`` (per block,
    None where its rate is 0, else (attention branch, MLP branch) as
    float32 [B])."""
    masks = iter(masks_fn(variables, key))
    out = []
    for block in model.blocks:
        drawn = [np.asarray(next(masks)) for _ in range(2)]
        rows = [torch.tensor(m.reshape(m.shape[0], -1)[:, 0], dtype=torch.float32)
                for m in drawn]
        out.append(None if block.drop_path1.rate == 0.0 else tuple(rows))
    assert next(masks, None) is None, "the JAX model drew more DropPath masks than the port"
    return out


def _port(cfg, params):
    pcfg = port_cfg(cfg)
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    load_jax_params(model, params)
    return pcfg, model


def _port_steps(cfg, params, batches, rng, draws_of=None):
    """The port's model after two train steps of ``cfg`` from ``params``,
    and each step's metrics; ``draws_of(i, batch)`` gives step i's draws
    (JAX's preprocessing and MixUp draws when None)."""
    pcfg, model = _port(cfg, params)
    state = init_state(pcfg, model)
    step = make_train_step(pcfg, device="cpu")
    metrics = []
    for i, (batch, lr) in enumerate(zip(batches, LRS)):
        draws = (draws_of or (lambda i, b: jax_train_draws(cfg, rng, i, b["frames"].shape)))(
            i, batch)
        metrics.append({k: float(v) for k, v in step(state, batch, lr, draws).items()})
    return model, metrics


def test_act_checkpoint_step_equals_plain_step():
    """(a)"""
    cfg, plain_cfg = remat_cfg("act_checkpoint", 0.1), remat_cfg(dropout=0.1)
    batches = [mvit_train._batch(cfg, 2, seed) for seed in (0, 1)]
    _, jstate, _ = _jax_state(plain_cfg, batches[0])
    rng = jax.random.PRNGKey(3)
    g = torch.Generator().manual_seed(7)
    _, probe = _port(plain_cfg, jstate.params)
    masks = [(probe.sample_drop_path_masks(2, g), probe.sample_dropout_masks(
        batches[0]["frames"].shape, g)) for _ in batches]

    def draws_of(i, batch):
        draws = jax_train_draws(cfg, rng, i, batch["frames"].shape)
        draws["drop_path"], draws["dropout_masks"] = masks[i]
        return draws

    got, got_m = _port_steps(cfg, jstate.params, batches, rng, draws_of)
    want, want_m = _port_steps(plain_cfg, jstate.params, batches, rng, draws_of)
    for a, b in zip(got_m, want_m):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0, err_msg=k)
    for name, value in want.state_dict().items():
        np.testing.assert_allclose(got.state_dict()[name].numpy(), value.numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_remat_train_steps_match_jax(knob, depthwise_calls):  # noqa: F811
    """(b), and (c)'s count of K1 calls: a rematted block 0 runs its q-pool
    twice a step."""
    cfg = remat_cfg(knob, 0.1)
    plain = remat_cfg(dropout=0.1)  # the same masks, read without nn.remat
    batches = [mvit_train._batch(cfg, 2, seed) for seed in (0, 1)]
    jmodel, jstate, tx = _jax_state(cfg, batches[0])
    jplain = jax_build_model(plain, dtype=jnp.float32)
    jstep = jax.jit(jsteps.make_train_step(cfg, jmodel, tx))
    rng = jax.random.PRNGKey(3)
    _, probe = _port(plain, jstate.params)
    x = np.zeros(batches[0]["frames"].shape, np.float32)
    drop_path_fn = jax_dropout_masks_fn(jplain, x, DropPath)
    dropout_fn = jax_dropout_masks_fn(jplain, x)
    masks = []
    params = jstate.params
    for i, batch in enumerate(batches):
        key = jax_dropout_key(rng, i)
        dropouts = iter(dropout_fn({"params": params}, key))

        def fill(entry):
            if entry is None:
                return None
            if isinstance(entry, (list, tuple)):
                return type(entry)(fill(e) for e in entry)
            return torch.tensor(np.asarray(next(dropouts)), dtype=torch.float32)

        masks.append((jax_mvit_drop_path_masks(drop_path_fn, {"params": params}, key, probe),
                      fill(probe.sample_dropout_masks(x.shape, torch.Generator()))))
        assert next(dropouts, None) is None
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng, LRS[i])
        masks[-1] += ({k: float(v) for k, v in jm.items()},)
        params = jstate.params

    def draws_of(i, batch):
        draws = jax_train_draws(cfg, rng, i, batch["frames"].shape)
        draws["drop_path"], draws["dropout_masks"] = masks[i][:2]
        return draws

    _, init, _ = _jax_state(cfg, batches[0])
    model, metrics = _port_steps(cfg, init.params, batches, rng, draws_of)
    for m, (_, _, jm) in zip(metrics, masks):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-5)
        assert m["top1_err"] == jm["top1_err"] and m["top5_err"] == jm["top5_err"]
    _assert_params(model, jstate)
    # 9 stride-1 pools a forward (block 0's q-pool, block 1's K and V
    # pools, blocks 2-3's q, K and V pools), and each rematted block's again
    # in its recompute: all 9 under ACT_CHECKPOINT, blocks 0-1's 3 under
    # REMAT_MIN_SEQ.
    assert len(depthwise_calls) == 2 * (9 + (9 if knob == "act_checkpoint" else 3))


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_rematted_blocks_are_jax_rule(knob):
    """(c)"""
    cfg = remat_cfg(knob)
    want = jax_rematted(cfg)
    assert want == ({0, 1, 2, 3} if knob == "act_checkpoint" else {0, 1})
    pcfg = port_cfg(cfg)
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    calls = [0] * len(model.blocks)
    for i, block in enumerate(model.blocks):
        block.register_forward_pre_hook(lambda *_, i=i: calls.__setitem__(i, calls[i] + 1))
    state = init_state(pcfg, model)
    step = make_train_step(pcfg, device="cpu")
    step(state, mvit_train._batch(cfg, 2, 0), 1e-3)
    assert {i for i, n in enumerate(calls) if n == 2} == want
    assert {i for i, n in enumerate(calls) if n == 1} == set(range(4)) - want
    calls[:] = [0] * 4
    x = torch.zeros(2, 4, 16, 16, 3)
    model.eval()
    model(x)
    model.train()
    with torch.no_grad():
        model(x)
    assert calls == [2] * 4


def _saved_bytes(cfg):
    """The bytes of the distinct tensors autograd saves in one train-mode
    forward of ``cfg``'s tiny MViT."""
    pcfg = port_cfg(cfg)
    torch.manual_seed(0)
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    model.train()
    seen = {}

    def pack(t):
        seen[(t.data_ptr(), tuple(t.shape), t.dtype)] = t.numel() * t.element_size()
        return t

    x = torch.randn(2, 4, 16, 16, 3)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = model(x).square().sum()
    loss.backward()
    return sum(seen.values())


def test_saved_bytes_fall_with_the_knob():
    """(d)"""
    plain = _saved_bytes(remat_cfg())
    partial = _saved_bytes(remat_cfg("remat_min_seq"))
    every = _saved_bytes(remat_cfg("act_checkpoint"))
    assert every < partial < plain, (every, partial, plain)
