"""The port's multigrid pieces, its SubBatchNorm, precise BN over it, the
profiler window and the data-loading benchmark against the JAX package's.

- The schedule (``utils/multigrid.py``): every cfg field that
  ``init_multigrid`` and ``update_long_cycle`` write, at every epoch, equal
  to ``pmv_tpu.utils.multigrid.MultigridSchedule``'s (exact), with
  ``is_eval_epoch`` and the LR of every quarter epoch: the stepwise SlowFast
  yaml at its own values, with the overrides of the 64-video run
  (TRAIN.BATCH_SIZE 2, BN_BASE_SIZE 2, STEPS [0, 3], MAX_EPOCH 4), with a
  BN_BASE_SIZE that makes a cycle's batch factor fall below 1
  (sync_batchnorm), and with short cycles alone (EPOCH_FACTOR).
- The short-cycle loader on ``Synthetic`` (configs/tiny_multigrid_synthetic
  .yaml at epochs 0, 4 and 5 of its schedule): its length, each batch's
  samples and frames (the short phases' crops) equal to JAX's
  ``construct_loader``'s; 2 ranks' rows of each step together equal to one
  process's.
- SubBatchNorm (``BatchNorm`` with ``num_splits``) against flax's
  ``SubBatchNorm``: the train forward, the running statistics and the
  gradients, then eval on its aggregate statistics, float32, atol 1e-5; a
  batch the splits do not divide raises; the statistics' conversion of a
  BatchNorm-type change against ``adapt_state_across_bn`` (exact).
- Precise BN over a tiny SlowFast of SubBatchNorms (2 splits) against
  ``pmv_tpu.engine.precise_bn`` (atol 2e-4, rtol 1e-4, as for BatchNorm).
- ``benchmark_data_loading`` counts the clips that JAX's does over a short
  cycle's epoch; ``python -m pmv_tpu_torch.tools.benchmark`` runs.
- ``run_net --device cpu`` with TPU.PROFILE_DIR writes one trace of the
  window's steps.
"""

import json

import jax
import numpy as np
import pytest
import torch
import yaml

import pmv_tpu.data  # noqa: F401  (registers the JAX datasets)
from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.data.loader import construct_loader as jax_construct_loader
from pmv_tpu.engine import precise_bn as jprecise_bn
from pmv_tpu.engine.train_state import TrainState
from pmv_tpu.models.batchnorm import SubBatchNorm as JaxSubBatchNorm
from pmv_tpu.parallel import mesh as mesh_lib
from pmv_tpu.utils import benchmark as jbenchmark
from pmv_tpu.utils import checkpoint as jcu
from pmv_tpu.utils import lr_policy as jlr
from pmv_tpu.utils import misc as jmisc
from pmv_tpu.utils.multigrid import MultigridSchedule as JaxMultigridSchedule
from pmv_tpu_torch.data.loader import DataLoader
from pmv_tpu_torch.data.loader import construct_loader
from pmv_tpu_torch.engine.precise_bn import calculate_and_update_precise_bn
from pmv_tpu_torch.engine.steps import init_state
from pmv_tpu_torch.models.batchnorm import BatchNorm
from pmv_tpu_torch.tools import benchmark as benchmark_cli
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.utils import lr_policy, misc
from pmv_tpu_torch.utils.benchmark import benchmark_data_loading
from pmv_tpu_torch.utils.multigrid import MultigridSchedule
from pmv_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_resnet import ROOT, TINY_SLOWFAST
from torch_port_util import numpy_tree, one_thread, port_cfg  # noqa: F401

STEPWISE = str(ROOT / "configs" / "Kinetics" / "SLOWFAST_8x8_R50_stepwise_multigrid.yaml")
TINY_MULTIGRID = str(ROOT / "configs" / "tiny_multigrid_synthetic.yaml")
RUN_64 = ["TRAIN.BATCH_SIZE", "2", "MULTIGRID.BN_BASE_SIZE", "2", "SOLVER.MAX_EPOCH", "4",
          "SOLVER.STEPS", "[0, 3]", "NUM_GPUS", "1"]
SCHEDULES = {
    "stepwise": (STEPWISE, []),
    "run_64_videos": (STEPWISE, RUN_64),
    "sync_batchnorm": (STEPWISE, ["MULTIGRID.BN_BASE_SIZE", "16"]),
    "short_cycle_only": (STEPWISE, ["MULTIGRID.LONG_CYCLE", "False"]),
}
SECTIONS = ("SOLVER", "MULTIGRID", "BN", "DATA", "TRAIN")
# The fields the schedule writes (`multigrid.py` of both packages).
WRITTEN = ("SOLVER.STEPS", "SOLVER.LRS", "SOLVER.MAX_EPOCH", "MULTIGRID.DEFAULT_B",
           "MULTIGRID.DEFAULT_T", "MULTIGRID.DEFAULT_S", "MULTIGRID.LONG_CYCLE_SAMPLING_RATE",
           "DATA.NUM_FRAMES", "DATA.TRAIN_CROP_SIZE", "TRAIN.BATCH_SIZE", "BN.NORM_TYPE",
           "BN.NUM_SPLITS", "BN.NUM_SYNC_DEVICES")


def jax_cfg(path, *opts):
    cfg = jax_get_cfg()
    cfg.merge_from_file(path)
    cfg.merge_from_list(list(opts))
    return cfg


def _sections(cfg):
    """The sections of ``cfg`` that hold what the schedule writes, as plain
    data."""
    dumped = yaml.safe_load(cfg.dump())
    return {k: dumped[k] for k in SECTIONS}


def _written(cfg):
    values = []
    for key in WRITTEN:
        section, name = key.split(".")
        value = cfg[section][name]
        values.append(list(value) if isinstance(value, (list, tuple)) else value)
    return values


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_matches_jax(case):
    path, opts = SCHEDULES[case]
    jcfg = jax_cfg(path, *opts)
    pcfg = port_cfg(jcfg)
    jmg, pmg = JaxMultigridSchedule(), MultigridSchedule()
    jcfg, pcfg = jmg.init_multigrid(jcfg), pmg.init_multigrid(pcfg)
    assert pmg.schedule == jmg.schedule
    assert _sections(pcfg) == _sections(jcfg)
    norm_types = set()
    for epoch in range(jcfg.SOLVER.MAX_EPOCH):
        if jcfg.MULTIGRID.LONG_CYCLE:
            (jcfg, jchanged), (pcfg, pchanged) = (jmg.update_long_cycle(jcfg, epoch),
                                                  pmg.update_long_cycle(pcfg, epoch))
            assert pchanged == jchanged, epoch
            assert _written(pcfg) == _written(jcfg), epoch
            norm_types.add(pcfg.BN.NORM_TYPE)
        assert (misc.is_eval_epoch(pcfg, epoch, pmg.schedule)
                == jmisc.is_eval_epoch(jcfg, epoch, jmg.schedule)), epoch
        for quarter in range(4):
            at = epoch + quarter / 4
            assert lr_policy.get_lr_at_epoch(pcfg, at) == jlr.get_lr_at_epoch(jcfg, at), at
    assert _sections(pcfg) == _sections(jcfg)
    if case == "run_64_videos":  # the schedule of the run on the card
        assert pmg.schedule == [(0, [8, 8, 158], 2), (0, [4, 16, 158], 4), (0, [2, 16, 224], 5),
                                (0, [1, 32, 224], 5), (1, [1, 32, 224], 6)]
        assert norm_types == {"sub_batchnorm", "batchnorm"}
    if case == "sync_batchnorm":
        assert "sync_batchnorm" in norm_types


def _multigrid_cfgs(epoch):
    """The tiny multigrid config at ``epoch`` of its schedule: JAX's, the
    port's."""
    jcfg = jax_cfg(TINY_MULTIGRID)
    mg = JaxMultigridSchedule()
    jcfg = mg.init_multigrid(jcfg)
    mg.update_long_cycle(jcfg, epoch)
    return jcfg, port_cfg(jcfg)


@pytest.mark.parametrize("epoch", [0, 4, 5])
def test_short_cycle_loader_matches_jax(epoch):
    jcfg, pcfg = _multigrid_cfgs(epoch)
    jloader, ploader = jax_construct_loader(jcfg, "train"), construct_loader(pcfg, "train")
    assert ploader.short_cycle == jloader.short_cycle
    assert len(ploader) == len(jloader)
    jloader.set_epoch(1)
    ploader.set_epoch(1)
    pbatches = list(ploader)
    jbatches = list(jloader)
    assert len(pbatches) == len(jbatches) == len(ploader)
    for p, j in zip(pbatches, jbatches):
        np.testing.assert_array_equal(p["index"], j["index"])
        np.testing.assert_array_equal(p["frames"], j["frames"])
    crops = [b["frames"].shape[2] for b in pbatches[:3]]
    short = [int(round(f * pcfg.MULTIGRID.DEFAULT_S)) for f in pcfg.MULTIGRID.SHORT_CYCLE_FACTORS]
    assert crops == short + [pcfg.DATA.TRAIN_CROP_SIZE]
    assert [b["frames"].shape[1] for b in pbatches] == [pcfg.DATA.NUM_FRAMES] * len(pbatches)

    # Two ranks, each a contiguous share of each phase's global batch.
    ranks = [DataLoader(ploader.dataset, ploader.batch_size // 2, shuffle=True, drop_last=True,
                        seed=pcfg.RNG_SEED, rank=r, world_size=2,
                        short_cycle=ploader.short_cycle, num_workers=1) for r in (0, 1)]
    for loader in ranks:
        assert len(loader) == len(ploader)
        loader.set_epoch(1)
    for step, (b0, b1) in enumerate(zip(*ranks)):
        np.testing.assert_array_equal(np.concatenate([b0["index"], b1["index"]]),
                                      pbatches[step]["index"])


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_sub_batchnorm_matches_flax(splits):
    rng = np.random.default_rng(splits)
    c = 6
    x = (2.0 + 3.0 * rng.normal(size=(8, 2, 3, 3, c))).astype(np.float32)
    x[:4] += 1.5  # the splits' means apart
    cot = rng.normal(size=x.shape).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(size=c).astype(np.float32)}
    stats = {"mean": (0.3 * rng.normal(size=splits * c)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, splits * c).astype(np.float32)}
    jbn = JaxSubBatchNorm(num_splits=splits)

    def loss(params, x):
        y, updates = jbn.apply({"params": params, "batch_stats": stats}, x,
                               use_running_average=False, mutable=["batch_stats"])
        return (y * cot).sum(), (y, updates["batch_stats"])

    (_, (y, new_stats)), (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, x)
    y_eval = jbn.apply({"params": params, "batch_stats": stats}, x, use_running_average=True)

    bn = BatchNorm(c, num_splits=splits)
    bn.load_state_dict(state_dict_from_jax({"params": params, "batch_stats": stats}))
    xt = torch.from_numpy(x).requires_grad_()
    out = bn.train()(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(g_params["scale"]), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(g_params["bias"]), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new_stats["mean"]), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new_stats["var"]), **tol)
    assert int(bn.num_batches_tracked) == 1
    bn.load_state_dict(state_dict_from_jax({"params": params, "batch_stats": stats}))
    with torch.no_grad():
        np.testing.assert_allclose(bn.eval()(torch.from_numpy(x)).numpy(), np.asarray(y_eval),
                                   **tol)


def test_sub_batchnorm_refuses_a_batch_its_splits_do_not_divide():
    bn = BatchNorm(4, num_splits=3).train()
    with pytest.raises(ValueError, match="batch 4 not divisible by num_splits 3"):
        bn(torch.zeros(4, 2, 4))


@pytest.mark.parametrize("before,after", [(0, 8), (8, 4), (4, 2), (2, 0), (8, 0), (2, 2)])
def test_set_splits_converts_as_adapt_state_across_bn(before, after):
    """The running statistics across a BatchNorm-type change, as the JAX
    package carries them: tiled to more values, the plain mean to fewer;
    the parameters and their objects kept."""
    rng = np.random.default_rng(before * 10 + after)
    c = 5

    def stats(splits, draw):
        n = max(splits, 1) * c
        return {"mean": draw(n), "var": draw(n)}

    old = stats(before, lambda n: rng.normal(size=n).astype(np.float32))
    template = stats(after, lambda n: np.zeros(n, np.float32))
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(size=c).astype(np.float32)}
    jstate = jcu.adapt_state_across_bn(
        TrainState(step=3, params={"bn": params}, batch_stats={"bn": old}, opt_state=()),
        TrainState(step=0, params={"bn": params}, batch_stats={"bn": template}, opt_state=()))
    bn = BatchNorm(c, num_splits=before)
    bn.load_state_dict(state_dict_from_jax({"params": params, "batch_stats": old}))
    weight = bn.weight
    bn.set_splits(after)
    assert bn.num_splits == after and bn.weight is weight
    np.testing.assert_array_equal(bn.running_mean.numpy(),
                                  np.asarray(jstate.batch_stats["bn"]["mean"]))
    np.testing.assert_array_equal(bn.running_var.numpy(),
                                  np.asarray(jstate.batch_stats["bn"]["var"]))


def test_precise_bn_over_sub_batchnorm_matches_jax():
    import test_torch_port_slowfast_train as sf

    cfg = sf._cfg("BN.NORM_TYPE", "sub_batchnorm", "BN.NUM_SPLITS", "2",
                  "BN.NUM_BATCHES_PRECISE", "2")
    batches = [sf._batch(cfg, seed) for seed in (5, 6)]
    jmodel, jstate, _ = sf._jax_state(cfg, batches[0], 8)
    want = jprecise_bn.calculate_and_update_precise_bn(
        batches, jstate, cfg, jmodel, mesh_lib.create_mesh(devices=jax.devices()[:1]))
    model = sf._port(cfg, jstate)
    splits = [m.num_splits for m in model.modules() if isinstance(m, BatchNorm)]
    assert 2 in splits and 0 in splits  # the stems' BatchNorms stay plain, as in JAX
    before = {k: v.clone() for k, v in model.state_dict().items()}
    calculate_and_update_precise_bn(batches, init_state(port_cfg(cfg), model), port_cfg(cfg),
                                    "cpu")
    got = model.state_dict()
    ref = state_dict_from_jax(numpy_tree({"params": {}, "batch_stats": want.batch_stats}))
    for name, value in ref.items():
        if name.endswith("num_batches_tracked"):
            assert torch.equal(got[name], before[name]), name
            continue
        assert got[name].shape == value.shape, name
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=2e-4, rtol=1e-4,
                                   err_msg=name)
        assert not torch.equal(got[name], before[name]), name


def test_benchmark_counts_the_clips_jax_counts(tmp_path, monkeypatch):
    jcfg, pcfg = _multigrid_cfgs(0)
    for cfg in (jcfg, pcfg):
        cfg.BENCHMARK.NUM_EPOCHS, cfg.BENCHMARK.LOG_PERIOD = 2, 2
        cfg.OUTPUT_DIR = str(tmp_path)
    logged = []
    monkeypatch.setattr(jbenchmark.logger, "info", lambda msg, *a: logged.append(msg % a))
    # The JAX package's setup_logging configures its logger once a process,
    # for the first OUTPUT_DIR it is given: left to run here, a later test in
    # this worker whose JAX run expects its own OUTPUT_DIR made finds none.
    monkeypatch.setattr(jbenchmark.pmv_logging, "setup_logging", lambda *a, **k: None)
    jbenchmark.benchmark_data_loading(jcfg)
    jax_total = int(next(m for m in logged if "clips loaded" in m).split()[2])
    _, total = benchmark_data_loading(pcfg)
    assert total == jax_total == 2 * 64  # two epochs of the short cycle's 32 + 16 + 16

    assert benchmark_cli.main(["--cfg", TINY_SLOWFAST, "--opts", "BENCHMARK.NUM_EPOCHS", "1",
                               "BENCHMARK.LOG_PERIOD", "4", "OUTPUT_DIR", str(tmp_path)]) == 0
    log = (tmp_path / "stdout.log").read_text()
    assert "Benchmark complete: 64 clips loaded" in log and "iter 8:" in log


def test_profiler_window_writes_one_trace(tmp_path, one_thread):  # noqa: F811
    """8 steps of 8 clips: the window is steps 0 to 2 of epoch 0."""
    out, trace_dir = tmp_path / "job", tmp_path / "trace"
    assert run_net.main(["--cfg", TINY_SLOWFAST, "--device", "cpu", "--opts",
                         "OUTPUT_DIR", str(out), "TPU.PROFILE_DIR", str(trace_dir),
                         "TEST.ENABLE", "False", "BN.USE_PRECISE_STATS", "False",
                         "TRAIN.MIXED_PRECISION", "False",
                         "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "16",
                         "DATA.TEST_CROP_SIZE", "16"]) == 0
    traces = list(trace_dir.iterdir())
    assert len(traces) == 1 and traces[0].name.endswith(".pt.trace.json")
    events = json.loads(traces[0].read_text())["traceEvents"]
    steps = [e for e in events if e.get("name", "").startswith("ProfilerStep")]
    assert not steps and any(e.get("cat") == "cpu_op" for e in events)
    assert "Profiled steps 0 to 2 of epoch 0" in (out / "stdout.log").read_text()
