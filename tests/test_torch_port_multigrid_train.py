"""The port's multigrid training against the JAX package's: a train step of
SubBatchNorms, the BatchNorm swap of a long-cycle change both ways, and
``run_net`` on a multigrid schedule with a resume across a change.

- On configs/tiny_slowfast_synthetic.yaml with BN.NORM_TYPE sub_batchnorm
  and 2 splits, float32 on the CPU, batch 8 (4 rows a split: at 2 rows a
  split the last stage's statistics run over 16 values a channel, and
  float32's rounding alone moves the grad norm by 0.2 to 0.4%, JAX's own
  from run to run among it): one SGD step against the jitted
  JAX step (as tests/test_torch_port_slowfast_train.py holds the BatchNorm
  one: loss and grad norm to rtol 1e-4, top-k equal, the update, which
  holds the gradient, to atol 2e-4 of the largest, the split statistics to
  rtol 1e-4); the swap to batchnorm against ``adapt_state_across_bn``
  (parameters and their objects kept, statistics in its layout and under
  the step's gate); a second step from the swapped state, whose update
  carries the momentum trace of the first, equal bit for bit to the step
  of a model built plain with that state and the optimizer's; and the swap
  back, the statistics tiled.
- ``run_net --device cpu`` on configs/tiny_multigrid_synthetic.yaml: each
  epoch's batch, frames, crop and BatchNorm type and the evaluated epochs
  as the JAX schedule and ``is_eval_epoch`` give them, the checkpoints'
  statistics in each epoch's layout, the precise-BN line and test_final;
  then the checkpoint of epoch 3 (4 splits) in a fresh OUTPUT_DIR resumes
  at epoch 4 (2 splits) and ends with the uninterrupted run's weights, bit
  for bit.
"""

import copy
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_port_slowfast_train as sf
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.utils import checkpoint as jcu
from pmv_tpu.utils import misc as jmisc
from pmv_tpu.utils.multigrid import MultigridSchedule as JaxMultigridSchedule
from pmv_tpu_torch.engine.steps import init_state, make_train_step
from pmv_tpu_torch.models.batchnorm import BatchNorm, swap_norms
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.tools.grad_witness import relu_decisions
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_multigrid import TINY_MULTIGRID, jax_cfg
from torch_port_util import (  # noqa: F401
    jax_dropout_key,
    jax_dropout_masks,
    jax_relu_decisions,
    jax_train_draws,
    numpy_tree,
    one_thread,
    port_cfg,
)

SUB = ("BN.NORM_TYPE", "sub_batchnorm", "BN.NUM_SPLITS", "2")


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"frames": rng.integers(0, 256, (8, cfg.DATA.NUM_FRAMES, 32, 32, 3), np.uint8),
            "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, 8)}


def _steps_match(cfg, model, state, jmodel, jstate, tx, batch, step):
    """One step of the port's ``state`` and of JAX's ``jstate`` at step
    count ``step`` on ``batch``, held as the BatchNorm step is held;
    returns JAX's state after it."""
    rng = jax.random.PRNGKey(3)
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    (mask,) = jax_dropout_masks(jmodel, variables, sf._pathways(cfg, batch["frames"]),
                                jax_dropout_key(rng, step))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    draws = {**jax_train_draws(cfg, rng, step, batch["frames"].shape),
             "dropout": torch.tensor(mask, dtype=torch.float32)}
    with relu_decisions() as decisions:
        m = make_train_step(port_cfg(cfg), device="cpu")(state, batch, sf.LR, draws)
    jstep = jax.jit(jsteps.make_train_step(cfg, jmodel, tx))
    with jax_relu_decisions(decisions):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng, sf.LR)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert float(m["top1_err"]) == float(jm["top1_err"])
    assert float(m["top5_err"]) == float(jm["top5_err"])
    sf._assert_state_matches(model, jstate, before)
    return jstate


def _swap_matches(model, cfg, jstate, jtemplate):
    """The port's swap to ``cfg``'s norms against ``adapt_state_across_bn``
    onto ``jtemplate``. The parameters stay,
    the same objects with the same values; the statistics take JAX's
    layout and, converted, stay as close to JAX's as the step left them
    (its gate; the conversion alone is held exactly by
    tests/test_torch_port_multigrid.py)."""
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    objects = {n: p for n, p in model.named_parameters()}
    assert swap_norms(model, port_cfg(cfg)) > 0
    for name, p in model.named_parameters():
        assert p is objects[name] and torch.equal(p, params[name]), name
    jstate = jcu.adapt_state_across_bn(jstate, jtemplate)
    want = state_dict_from_jax(numpy_tree({"params": {}, "batch_stats": jstate.batch_stats}))
    got = model.state_dict()
    assert set(want) < set(got)
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            assert got[name].shape == value.shape, name
            np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=2e-5, rtol=1e-4,
                                       err_msg=name)


def test_sub_batchnorm_step_and_swaps_match_jax():
    cfg_sub, cfg_plain = sf._cfg(*SUB), sf._cfg()
    batch = _batch(cfg_sub, 0)
    jmodel_sub, jstate, tx = sf._jax_state(cfg_sub, batch, 4)
    model = sf._port(cfg_sub, jstate)
    assert {m.num_splits for m in model.modules() if isinstance(m, BatchNorm)} == {0, 2}
    state = init_state(port_cfg(cfg_sub), model)
    jstate = _steps_match(cfg_sub, model, state, jmodel_sub, jstate, tx, batch, 0)

    # A long cycle of a smaller batch: to plain BatchNorm, then a step that
    # carries the momentum trace of the first. It equals, bit for bit, the
    # step of a model built plain with the swapped state and the optimizer's
    # (the plain step is held to JAX's by test_torch_port_slowfast_train.py,
    # SGD's trace over steps to optax's by test_torch_port_optim.py).
    _, jtemplate_plain, _ = sf._jax_state(cfg_plain, batch, 4)
    _swap_matches(model, cfg_plain, jstate, jtemplate_plain)
    assert state.optimizer.state[model.s1_fuse.bn.weight]["trace"].abs().sum() > 0
    fresh = build_model(port_cfg(cfg_plain), device="cpu", dtype=torch.float32)
    fresh.load_state_dict(model.state_dict(), strict=True)
    fresh_state = init_state(port_cfg(cfg_plain), fresh)
    # A copy: load_state_dict keeps the very tensors, which both steps would move.
    fresh_state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    fresh_state.step = state.step
    batch2 = _batch(cfg_plain, 1)
    step = make_train_step(port_cfg(cfg_plain), device="cpu")
    draws = step.sample_draws(fresh, batch2["frames"].shape, 1)
    got, want = step(state, batch2, sf.LR, draws), step(fresh_state, batch2, sf.LR, draws)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    for (name, value), ref in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(value, ref), name

    # And back: the statistics tiled to the 2 splits, as JAX tiles them.
    before = {n: v.clone() for n, v in model.state_dict().items() if "running" in n}
    assert swap_norms(model, port_cfg(cfg_sub)) > 0
    for name, value in model.state_dict().items():
        if "running" in name:
            split = model.get_submodule(name.rsplit(".", 1)[0]).num_splits
            assert torch.equal(value, before[name].repeat(max(split, 1))), name


def _epochs(log):
    """(epoch, clips a step, frames, crop, norm) of each 'Epoch N:' line."""
    return [(int(m[1]), int(m[2]), int(m[3]), int(m[4]), m[5]) for m in re.finditer(
        r"Epoch (\d+): (\d+) clips a step \(\d+ steps\), (\d+) frames, crop (\d+), (.+)", log)]


def test_run_net_trains_the_multigrid_schedule_and_resumes_across_a_bn_change(
        tmp_path, one_thread):  # noqa: F811
    jcfg = jax_cfg(TINY_MULTIGRID)
    mg = JaxMultigridSchedule()
    jcfg = mg.init_multigrid(jcfg)
    want, evals = [], []
    for epoch in range(jcfg.SOLVER.MAX_EPOCH):
        mg.update_long_cycle(jcfg, epoch)
        norm = jcfg.BN.NORM_TYPE
        if norm == "sub_batchnorm":
            norm += f" ({jcfg.BN.NUM_SPLITS} splits)"
        want.append((epoch, jcfg.TRAIN.BATCH_SIZE, jcfg.DATA.NUM_FRAMES,
                     jcfg.DATA.TRAIN_CROP_SIZE, norm))
        evals.append(jmisc.is_eval_epoch(jcfg, epoch, mg.schedule))
    assert [w[4] for w in want] == ["sub_batchnorm (8 splits)"] * 2 + [
        "sub_batchnorm (4 splits)"] * 2 + ["sub_batchnorm (2 splits)", "batchnorm"]

    out = tmp_path / "job"
    argv = ["--cfg", TINY_MULTIGRID, "--device", "cpu", "--opts", "OUTPUT_DIR"]
    assert run_net.main(argv + [str(out)]) == 0
    log = (out / "stdout.log").read_text()
    assert _epochs(log) == want
    assert log.count('"_type": "val_epoch"') == sum(evals)
    assert log.count("Updated precise BN stats over 2 batches") == len(want)
    assert '"split": "test_final"' in log.splitlines()[-1]
    name = "s2.pathway0_res0.branch2.a_bn.running_mean"
    stem = "s1.pathway0_stem.bn.running_mean"
    for epoch, splits in ((1, 8), (3, 4), (4, 2), (5, 1)):
        ckpt = torch.load(out / "checkpoints" / f"checkpoint_epoch_{epoch + 1:05d}.pyth",
                          weights_only=True)["model_state"]
        assert ckpt[name].shape == (splits * 8,) and ckpt[stem].shape == (8,)

    # The checkpoint of epoch 3 (4 splits) resumes at epoch 4 (2 splits).
    resumed = tmp_path / "resumed"
    (resumed / "checkpoints").mkdir(parents=True)
    shutil.copy(out / "checkpoints" / "checkpoint_epoch_00004.pyth", resumed / "checkpoints")
    assert run_net.main(argv + [str(resumed)]) == 0
    log2 = (resumed / "stdout.log").read_text()
    assert "Start epoch: 5" in log2 and _epochs(log2) == want[4:]
    final = "checkpoint_epoch_00006.pyth"
    got = torch.load(resumed / "checkpoints" / final, weights_only=True)
    ref = torch.load(out / "checkpoints" / final, weights_only=True)
    for key, value in ref["model_state"].items():
        assert torch.equal(got["model_state"][key], value), key
    assert log2.splitlines()[-1].split("json_stats: ")[1] == log.splitlines()[-1].split(
        "json_stats: ")[1]
