"""MaskMViT's backbone under per-block recompute (MODEL.ACT_CHECKPOINT) and
with MVIT.DROPOUT_RATE, against the JAX package's masked step.

The tiny MaskMViT of tests/test_torch_port_maskfeat_train.py (depth 2,
width 8, 4 frames of 32^2, block 0's stride-1 q-pool on K1's plain
version), its PT step (AdamW, the grad norm clipped at 0.02), a loader mask
and the JAX package's HOG bins held; float32 on the CPU. One step of the
port against the jitted JAX ``make_masked_train_step``:

- under MODEL.ACT_CHECKPOINT, which the JAX MaskMViT's backbone takes as
  its MViT does (`pmv_tpu/models/masked.py:152`); the decoder's blocks are
  plain in both;
- with MVIT.DROPOUT_RATE 0.1, the port fed the keep masks that the JAX
  step's "dropout" key draws (`pmv_tpu/engine/ssl_steps.py:86-97`), read
  off the JAX model's Dropout modules (``jax_model_dropout_masks``).

Gates: loss and grad norm to rtol 1e-5, every parameter after AdamW to atol
1e-5. The rank's cut of these masks under dp_sp is held in
tests/test_torch_port_sequence_parallel_tasks.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_maskfeat_train as mf
from pmv_tpu.engine import ssl_steps as jssl
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine.train_state import TrainState
from pmv_tpu.models import optimizer as joptim
from pmv_tpu_torch.engine import ssl_steps
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_util import (
    jax_dropout_key,
    jax_hog_bins,
    jax_model_dropout_masks,
    numpy_tree,
    port_cfg,
)


def _masked_cfg(case):
    cfg = mf._step_cfg()
    if case == "act_checkpoint":
        cfg.MODEL.ACT_CHECKPOINT = True
    else:
        cfg.MVIT.DROPOUT_RATE = 0.1
    return cfg


@pytest.mark.parametrize("case", ["act_checkpoint", "dropout"])
def test_masked_step_matches_jax(case):
    cfg = _masked_cfg(case)
    batch = mf._batch(2, 32, 0, n_tok=128)
    jmodel, params = mf._jax_model_and_params(cfg)
    tx = joptim.construct_optimizer(params, cfg)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                        opt_state=tx.init(params))
    jstep = jssl.make_masked_train_step(cfg, jmodel, tx)
    preprocess = jsteps.make_preprocess_fn(cfg, train=True)
    rng = jax.random.PRNGKey(3)

    def step_and_input(state, batch):
        k_pre = jax.random.split(jax.random.fold_in(rng, 0), 3)[0]
        return jstep(state, batch, rng, mf.LR), preprocess(k_pre, batch["frames"])

    (jstate, jm), x = jax.jit(step_and_input)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    pcfg = port_cfg(cfg)
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    draws = {"hog_bins": torch.tensor(jax_hog_bins(x))}
    if case == "dropout":
        draws["dropout_masks"], head = jax_model_dropout_masks(
            jmodel, {"params": params}, np.zeros(batch["frames"].shape, np.float32),
            jax_dropout_key(rng, 0), model, mask=jnp.asarray(batch["mask"]))
        assert head is None and draws["dropout_masks"] is not None
    state = ssl_steps.init_masked_state(pcfg, model)
    step = ssl_steps.make_masked_train_step(pcfg, device="cpu")
    m = step(state, batch, mf.LR, draws)
    assert not bool(m["nan"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    want = state_dict_from_jax(numpy_tree(jstate.params))
    for name, value in want.items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(), value.numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)
