"""Temporal sequence parallelism (TPU.SHARD_STRATEGY dp_sp) of the BatchNorm
conv families on the CPU: X3D, the ResNet family with a non-local block,
SlowFast, CSN, R(2+1)D and AVSlowFast.

- The halo arithmetic, in one process (the collective simulated as in
  tests/test_torch_port_sequence_parallel.py): each rank's conv or pool on
  its T slice extended by its halo planes tiles the one on the whole clip,
  forward and both gradients, for X3D's 5x1x1 channelwise stem conv, the
  SlowFast fusion's 7x1x1 conv at T stride 4, CSN's stride-2 depthwise
  conv_b, R(2+1)D's 3x1x1 conv at T stride 2, the shortcut's 1x1x1 conv at
  T stride 2 and I3D's pathway pool (T kernel 2, stride 2).
- ``pack_pathways`` on a rank's frames gives the clip's slow frames of that
  rank; a rank's frames that SLOWFAST.ALPHA does not divide raise
  ValueError. AVSlowFast's audio goes whole to every rank.
- One spawn of 2 ranks over gloo, a grid of data 1 x model 2, each rank the
  global batch's 4 rows and half of their frames:
  - tiny X3D (8 frames, K1 on each rank's 4 + 2 halo planes) and tiny
    SlowFast (8 frames: 4 fast and 1 slow a rank) against the JAX package's
    one-process step on the global batch from the same numpy-seeded weights
    and draws: loss and grad norm to rtol 1e-4, the weights and BatchNorm
    statistics as each model's one-process parity test holds them, the
    gradients against the port's one-process step (relative L2 1e-5). Both
    steps run in float64 activations, JAX's under ``jax.enable_x64``, and
    JAX's ReLUs take the one-process step's decisions, as
    tests/test_torch_port_csn.py holds CSN: a float32 ReLU input within a
    rounding of 0 decides either way and moves these nets' gradients, and
    JAX's float32 floor on X3D's stem weights lies above the gate;
  - tiny I3D with a non-local block in res3 (SlowFast builds none, in
    either package), CSN (16 frames, for its three T strides of 2),
    R(2+1)D and AVSlowFast (its audio whole on each rank) against the
    port's one-process step, which their own test files hold against JAX,
    all in float64 activations (the parameters and their gradients stay
    float32): metrics to rtol 1e-6, gradients by relative L2 1e-6 (the
    audio pathway's also on their own), weights and BatchNorm statistics
    to 1e-6;
  - for each, the eval scores against one process; precise BN of X3D and
    AVSlowFast, and X3D's ``perform_test`` (model rank 0's clips) against
    one process.
- The launch plans take a rank's X3D-M and ir-CSN-101 shapes under dp_sp.
- ``run_net`` on tiny X3D with NUM_GPUS 2 and TPU.SHARD_STRATEGY dp_sp:
  train, precise BN, the gathered eval and the test: test_final equals
  one process's, and the weights after the epoch's 16 float32 SGD steps lie
  within a relative L2 of 1e-3 of one process's (the ReLU decisions again).
"""

import contextlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_avslowfast as av_test
import test_torch_port_slowfast_train as sf_train
import test_torch_port_x3d_train as x3d_train
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine.train_state import TrainState
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models import optimizer as joptim
from pmv_tpu_torch.config import get_cfg
from pmv_tpu_torch.data.loader import DataLoader
from pmv_tpu_torch.engine import steps
from pmv_tpu_torch.engine.precise_bn import calculate_and_update_precise_bn
from pmv_tpu_torch.engine.steps import init_state, make_eval_step, make_train_step
from pmv_tpu_torch.engine.test import perform_test
from pmv_tpu_torch.models import build_model, common
from pmv_tpu_torch.models.batchnorm import BatchNorm
from pmv_tpu_torch.ops import depthwise as dw
from pmv_tpu_torch.parallel import mesh
from pmv_tpu_torch.tools.grad_witness import relu_decisions
from pmv_tpu_torch.utils import meters
from pmv_tpu_torch.utils.weights import load_jax_params
from test_torch_port_csn import tiny_cfg as csn_tiny_cfg
from test_torch_port_depthwise import _check_halo, _check_tiling
from test_torch_port_resnet import jax_variables
from test_torch_port_sequence_parallel import ROOT, _finish_run_net, _simulate_rank, _start_run_net
from test_torch_port_x3d import DEPTH_1
from torch_port_util import (
    ClipDataset,
    jax_dropout_key,
    jax_dropout_masks,
    jax_relu_decisions,
    jax_train_draws,
    join_ranks,
    port_cfg,
    rank_sp_cases,
    start_ranks,
)

RANKS = 2  # the model axis
LR = 0.05


# ------------------------------------------------------------ halo arithmetic


def _conv(c_in, c_out, kernel, stride, padding, groups=1):
    conv = common.ChannelsLastConv3d(c_in, c_out, kernel, stride, padding, groups=groups,
                                     bias=False).double()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, dtype=torch.float64,
                                      generator=torch.Generator().manual_seed(1)))
    return conv, [conv.weight]


def _halo_case(name):
    """(the op on [B, T, H, W, C], its parameters, the clip)."""
    gen = torch.Generator().manual_seed(0)
    clip = lambda t, c=4: torch.randn(2, t, 6, 5, c, dtype=torch.float64,  # noqa: E731
                                      generator=gen)
    if name == "x3d_stem":  # 5x1x1 channelwise, padded 2: 2 halo planes a side
        return (*_conv(4, 4, (5, 1, 1), (1, 1, 1), (2, 0, 0), groups=4), clip(8))
    if name == "fusion":  # 7x1x1 / 4, padded 3: 3 planes before, none after
        return (*_conv(4, 8, (7, 1, 1), (4, 1, 1), (3, 0, 0)), clip(16))
    if name == "csn_conv_b":  # depthwise 3x3x3 / 2: one plane before
        return (*_conv(4, 4, (3, 3, 3), (2, 2, 2), (1, 1, 1), groups=4), clip(8))
    if name == "r2plus1d_t":  # 3x1x1 / 2, padded 1
        return (*_conv(4, 6, (3, 1, 1), (2, 1, 1), (1, 0, 0)), clip(8))
    if name == "shortcut":  # 1x1x1 / (2, 2, 2): no halo, every other plane
        return (*_conv(4, 6, (1, 1, 1), (2, 2, 2), (0, 0, 0)), clip(8))
    op = lambda x: common.max_pool_3d(x, (2, 1, 1), (2, 1, 1), (0, 0, 0))  # noqa: E731
    return op, [], clip(8)  # I3D's pathway pool


@pytest.mark.parametrize("name", ["x3d_stem", "fusion", "csn_conv_b", "r2plus1d_t",
                                  "shortcut", "pool1"])
def test_halo_extended_slices_tile_the_whole_conv(monkeypatch, name):
    op, params, clip = _halo_case(name)
    whole = clip.clone().requires_grad_()
    y = op(whole)
    cot = torch.randn(y.shape, dtype=y.dtype, generator=torch.Generator().manual_seed(2))
    want = torch.autograd.grad((y * cot).sum(), [whole] + params)

    sliced = clip.clone().requires_grad_()
    t = clip.shape[1] // RANKS
    outs = []
    for m in range(RANKS):
        with monkeypatch.context() as patch:
            _simulate_rank(patch, sliced, m)
            outs.append(op(sliced[:, m * t:(m + 1) * t]))
    out = torch.cat(outs, dim=1)
    torch.testing.assert_close(out, y, atol=1e-12, rtol=0)
    got = torch.autograd.grad((out * cot).sum(), [sliced] + params)
    for g, w in zip(got, want):  # dx, then dw: the ranks' partial sums added
        torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-12)


def test_a_t_stride_must_divide_a_ranks_planes(monkeypatch):
    op, _, clip = _halo_case("shortcut")
    _simulate_rank(monkeypatch, clip, 0)
    with pytest.raises(ValueError, match="a rank's 3 planes are not a multiple of the T stride"):
        op(clip[:, :3])


def _slowfast_cfg(arch="slowfast"):
    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / "configs" / "tiny_slowfast_synthetic.yaml"))
    cfg.MODEL.ARCH = arch
    return cfg


@pytest.mark.parametrize("arch", ["slowfast", "avslowfast"])
def test_pack_pathways_takes_the_clips_slow_frames_of_a_rank(monkeypatch, arch):
    cfg = _slowfast_cfg(arch)
    clip = torch.arange(16.0).reshape(1, 16, 1, 1, 1)
    audio = torch.randn(1, 64, 16)
    for m in range(RANKS):
        with monkeypatch.context() as patch:
            _simulate_rank(patch, clip, m)
            inputs = steps.pack_pathways(cfg, clip[:, 8 * m:8 * (m + 1)],
                                         audio if arch == "avslowfast" else None)
        assert inputs[0].flatten().tolist() == [8.0 * m, 8.0 * m + 4]
        assert torch.equal(inputs[1], clip[:, 8 * m:8 * (m + 1)])
        if arch == "avslowfast":
            assert inputs[2] is audio


def test_pack_pathways_raises_where_alpha_does_not_divide_a_ranks_frames(monkeypatch):
    cfg = _slowfast_cfg()
    clip = torch.zeros(1, 12, 2, 2, 3)
    _simulate_rank(monkeypatch, clip, 1)
    with pytest.raises(ValueError, match="a rank's 6 frames are not a multiple of "
                                         "SLOWFAST.ALPHA 4"):
        steps.pack_pathways(cfg, clip[:, 6:])


# ------------------------------------------------------------ the spawn


def _frames(cfg, seed, b=4, t=None):
    rng = np.random.default_rng(seed)
    size = cfg.DATA.TRAIN_CROP_SIZE
    return {"frames": rng.integers(0, 256, (b, t or cfg.DATA.NUM_FRAMES, size, size, 3),
                                   np.uint8),
            "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, b)}


def _dp_sp(cfg):
    cfg.TPU.SHARD_STRATEGY = "dp_sp"
    return cfg


def _float64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _jax_case(name):
    """X3D's or SlowFast's case: the port's cfg and weights (the JAX tree's),
    the global batch, the JAX step's draws; and what the float64 JAX step
    needs (``_jax_step``). Under ``jax.enable_x64``, whose dropout masks
    the JAX step draws."""
    rng = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        if name == "x3d":
            cfg = x3d_train._cfg(*DEPTH_1, "DATA.NUM_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "32")
            batch = _frames(cfg, 1)
            jx = jnp.asarray(batch["frames"], jnp.float64)
        else:
            cfg = sf_train._cfg()
            batch = _frames(cfg, 1)
            jx = [jnp.asarray(x, jnp.float64) for x in sf_train._pathways(cfg, batch["frames"])]
        jmodel = jax_build_model(cfg, dtype=jnp.float64)
        variables = _float64(jax_variables(jmodel, jx, 4))
        tx = joptim.construct_optimizer(variables["params"], cfg)
        jstate = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]))
        draws = jax_train_draws(cfg, rng, 0, batch["frames"].shape)
        (mask,) = jax_dropout_masks(jmodel, variables, jx, jax_dropout_key(rng, 0))
    draws["dropout"] = torch.tensor(np.asarray(mask), dtype=torch.float32)
    pcfg = port_cfg(cfg)
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    load_jax_params(model, variables)
    case = {"cfg": _dp_sp(pcfg), "state_dict": {k: v.clone() for k, v in
                                                model.state_dict().items()},
            "batch": batch, "draws": draws, "lr": LR, "dtype": torch.float64,
            "eval": {"frames": _frames(cfg, 11)["frames"]}}
    if name == "x3d":
        rng_np = np.random.default_rng(12)
        case["test"] = {"frames": rng_np.integers(0, 256, (10, 8, 32, 32, 3), np.uint8),
                        "labels": rng_np.integers(0, cfg.MODEL.NUM_CLASSES, 5),
                        "num_clips": 2, "batch_size": 4}
        case["precise_batches"] = [_frames(cfg, seed) for seed in (5, 6)]
    return case, (cfg, jmodel, jstate, tx, rng)


def _port_case(name):
    """The port's seeded case of a family held against one process, in
    float64 activations."""
    if name == "i3d_nl":
        cfg = get_cfg()
        cfg.merge_from_file(str(ROOT / "configs" / "Kinetics" / "I3D_8x8_R50.yaml"))
        cfg.merge_from_list(["RESNET.DEPTH", 18, "RESNET.WIDTH_PER_GROUP", 8,
                             "NONLOCAL.LOCATION", [[[]], [[1]], [[]], [[]]],
                             "NONLOCAL.POOL", [[[1, 2, 2]], [[1, 2, 2]], [[1, 2, 2]],
                                               [[1, 2, 2]]],
                             "DATA.NUM_FRAMES", 8, "DATA.TRAIN_CROP_SIZE", 32,
                             "DATA.TEST_CROP_SIZE", 32, "MODEL.NUM_CLASSES", 5, "NUM_GPUS", 1])
    elif name in ("csn", "r2plus1d"):
        cfg = port_cfg(csn_tiny_cfg(name, *(("DATA.NUM_FRAMES", "16") if name == "csn"
                                           else ())))
    else:
        cfg = port_cfg(av_test.tiny_cfg())
    cfg = _dp_sp(cfg)
    cfg.TRAIN.MIXED_PRECISION = False
    model = build_model(cfg, device="cpu", dtype=torch.float64, seed=4)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():  # BatchNorm scales and biases away from 1 and 0
        for module in model.modules():
            if isinstance(module, BatchNorm):
                for p in (module.weight, module.bias):
                    p.add_(0.1 * torch.randn(p.shape, generator=gen, dtype=p.dtype))
    if name == "avslowfast":
        batch = av_test._batch(7)
        evals = {k: v for k, v in av_test._batch(11).items() if k in ("frames", "audio")}
    else:
        batch, evals = _frames(cfg, 7), {"frames": _frames(cfg, 11)["frames"]}
    draws = make_train_step(cfg, device="cpu").sample_draws(model, batch["frames"].shape)
    if name == "avslowfast":  # the audio fused into the slow pathway and its AVS loss
        draws["drop_pathway"] = False
    case = {"cfg": cfg, "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
            "batch": batch, "draws": draws, "lr": LR, "dtype": torch.float64, "eval": evals}
    if name == "avslowfast":
        case["precise_batches"] = [av_test._batch(seed) for seed in (5, 6)]
    return case


JAX_CASES = ("x3d", "slowfast")
PORT_CASES = ("i3d_nl", "csn", "r2plus1d", "avslowfast")


def _one_process(case, held=False):
    """The port's step, eval, precise BN and test of ``case`` in one process
    on the global batch; with ``held``, the step's ReLU decisions
    (``relu_decisions``) under "decisions"."""
    dtype = case.get("dtype", torch.float32)

    def model_of():
        model = build_model(case["cfg"], device="cpu", dtype=dtype)
        model.load_state_dict(case["state_dict"])
        return model

    model = model_of()
    step = make_train_step(case["cfg"], device="cpu")
    with relu_decisions() if held else contextlib.nullcontext() as decisions:
        metrics = step(init_state(case["cfg"], model), case["batch"], case["lr"],
                       case["draws"])
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
           "state": {k: v.clone() for k, v in model.state_dict().items()},
           "decisions": decisions}
    eval_step = make_eval_step(case["cfg"], model_of(), device="cpu")
    out["scores"] = eval_step(case["eval"]["frames"], None, case["eval"].get("audio")).clone()
    if "precise_batches" in case:
        model = model_of()
        calculate_and_update_precise_bn(case["precise_batches"], init_state(case["cfg"], model),
                                        case["cfg"], "cpu")
        out["precise_bn"] = {k: v.clone() for k, v in model.state_dict().items()
                             if "running" in k}
    if "test" in case:
        test = case["test"]
        loader = DataLoader(ClipDataset(test["frames"], test["labels"], test["num_clips"]),
                            test["batch_size"], num_workers=1)
        meter = meters.TestMeter(len(test["labels"]), test["num_clips"],
                                 case["cfg"].MODEL.NUM_CLASSES, len(loader))
        meter, stats = perform_test(loader, eval_step, meter)
        out["test"] = {"stats": stats, "video_preds": meter.video_preds}
    return out


def _jax_step(case, jax_args, decisions):
    """The JAX step on the global batch in float64 activations and weights
    (as tests/test_torch_port_csn.py runs it), its ReLUs taking
    ``decisions``."""
    cfg, jmodel, jstate, tx, rng = jax_args
    with jax.enable_x64(True), jax_relu_decisions(decisions):
        jstate, jm = jax.jit(jsteps.make_train_step(cfg, jmodel, tx))(
            jstate, {k: jnp.asarray(v) for k, v in case["batch"].items()}, rng, LR)
    return {"metrics": jm, "jstate": jstate, "cfg": cfg}


@pytest.fixture(scope="module")
def sp_ranks(tmp_path_factory):
    """Every case through ``rank_sp_cases`` on 2 ranks, and the references,
    computed here while the ranks run."""
    case_dir = tmp_path_factory.mktemp("sp_conv")
    with ThreadPoolExecutor(4) as pool:
        cases = {name: _port_case(name) for name in PORT_CASES}
        jax_args = {}
        for name in JAX_CASES:  # jax.enable_x64 holds the thread that enters it
            cases[name], jax_args[name] = _jax_case(name)
        torch.save(cases, case_dir / "sp_cases.pt")
        procs = start_ranks(rank_sp_cases, str(case_dir), model_size=RANKS)
        try:
            # The recording of the port's ReLU decisions patches F.relu, so
            # those steps run alone; JAX's held ReLUs patch flax's, beside the
            # port's other steps.
            refs = {name: _one_process(cases[name], held=True) for name in JAX_CASES}
            futures = {name: pool.submit(_one_process, cases[name]) for name in PORT_CASES}
            for name in JAX_CASES:
                refs[f"{name}_jax"] = _jax_step(cases[name], jax_args[name],
                                                refs[name]["decisions"])
            refs.update({name: future.result() for name, future in futures.items()})
        finally:
            join_ranks(procs)
    return torch.load(case_dir / "sp_results.pt", weights_only=False), refs, cases


def _relative_l2(got, want):
    diff = sum(float((got[k] - v).square().sum()) for k, v in want.items())
    return (diff / sum(float(v.square().sum()) for v in want.values())) ** 0.5


@pytest.mark.parametrize("name", JAX_CASES)
def test_dp_sp_step_matches_jax_on_the_global_batch(sp_ranks, name):
    results, refs, cases = sp_ranks
    jm, jstate = refs[f"{name}_jax"]["metrics"], refs[f"{name}_jax"]["jstate"]
    one = refs[name]
    model = build_model(cases[name]["cfg"], device="cpu", dtype=torch.float32)
    for rank, got in enumerate(results[name]):
        assert got["layout"] == mesh.Layout(0, 1, rank, RANKS)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][key], float(jm[key]), rtol=1e-4,
                                       err_msg=key)
        for key in ("top1_err", "top5_err"):
            np.testing.assert_allclose(got["metrics"][key], float(jm[key]), rtol=1e-6)
        assert not got["metrics"]["nan"]
        assert _relative_l2(got["grads"], one["grads"]) < 1e-5
        model.load_state_dict(got["state"])
        if name == "x3d":
            x3d_train._assert_state_matches(model, jstate)
        else:
            sf_train._assert_state_matches(model, jstate, cases[name]["state_dict"])
    first, second = results[name]
    for key, value in first["state"].items():  # every rank's statistics the same
        assert torch.equal(second["state"][key], value), key


@pytest.mark.parametrize("name", PORT_CASES)
def test_dp_sp_step_equals_one_process(sp_ranks, name):
    """Metrics, gradients (the audio pathway's of AVSlowFast on their own:
    its copy on each rank is reached through the sliced audio-to-slow sum
    and through the replicated AVS means), weights and BatchNorm statistics
    (the audio pathway's over the model group's copies of its rows)."""
    results, refs, _ = sp_ranks
    one = refs[name]
    audio = {k: v for k, v in one["grads"].items() if "pathway2" in k or "a2fs" in k}
    assert bool(audio) == (name == "avslowfast")
    for got in results[name]:
        for key, value in one["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], value, rtol=1e-6, atol=1e-9,
                                       err_msg=key)
        assert _relative_l2(got["grads"], one["grads"]) < 1e-6
        if audio:
            assert _relative_l2(got["grads"], audio) < 1e-6
            assert any("_avs" in key for key in got["metrics"])
        for key, value in one["state"].items():
            torch.testing.assert_close(got["state"][key], value, atol=1e-6, rtol=1e-6, msg=key)


@pytest.mark.parametrize("name", JAX_CASES + PORT_CASES)
def test_dp_sp_eval_equals_one_process(sp_ranks, name):
    results, refs, _ = sp_ranks
    for got in results[name]:
        torch.testing.assert_close(got["scores"], refs[name]["scores"], atol=1e-6, rtol=1e-5)


def test_dp_sp_k1_and_wgrad_run_on_halo_extended_slices(sp_ranks):
    """X3D's 7 stride-1 channelwise convs a forward take K1 on each rank's
    4 + 2 halo planes (forward, dx) and the wgrad kernel on the same
    extent; CSN's 5 on 8 + 2, 4 + 2, 2 + 2 and 1 + 2; the others none. Each rank's
    halos, gathers and means go through ``all_reduce``."""
    results, _, _ = sp_ranks
    for name in JAX_CASES + PORT_CASES:
        for got in results[name]:
            kinds = [kind for kind, _ in got["shapes"]]
            want = {"x3d": 7, "csn": 5}.get(name, 0)
            assert [kinds.count(k) for k in ("fwd", "dx", "wgrad")] == [want] * 3, name
            assert [k for k, _ in got["eval_shapes"]] == ["fwd"] * want, name
            planes = {shape[1] for _, shape in got["shapes"] + got["eval_shapes"]}
            assert planes <= ({6} if name == "x3d" else {10, 6, 4, 3}), (name, planes)
            assert got["traffic"]["halo"] > 0 and got["traffic"]["reduce"] > 0, name
            assert (got["traffic"]["gather"] > 0) == (name == "i3d_nl"), name


@pytest.mark.parametrize("name", ["x3d", "avslowfast"])
def test_dp_sp_precise_bn_equals_one_process(sp_ranks, name):
    results, refs, _ = sp_ranks
    for got in results[name]:
        for key, value in refs[name]["precise_bn"].items():
            torch.testing.assert_close(got["precise_bn"][key], value, atol=1e-6, rtol=1e-5,
                                       msg=key)


def test_dp_sp_perform_test_counts_model_rank_0s_clips(sp_ranks):
    results, refs, _ = sp_ranks
    one = refs["x3d"]["test"]
    for got in results["x3d"]:
        np.testing.assert_array_equal(got["test"]["clip_count"], [2] * 5)
        np.testing.assert_allclose(got["test"]["video_preds"], one["video_preds"], atol=1e-6,
                                   rtol=1e-5)
        assert got["test"]["stats"] == one["stats"]


def test_run_net_x3d_under_dp_sp_equals_one_process(tmp_path):
    """Tiny X3D at 4 frames (2 a rank, the stem's 2 halo planes the whole
    neighbour's slice), one epoch with precise BN, eval and test."""
    runs = {n: _start_run_net(tmp_path / f"x3d{n}", n, "TPU.SHARD_STRATEGY",
                              "dp_sp" if n == 2 else "dp", cfg="tiny_x3d_synthetic.yaml")
            for n in (2, 1)}
    (lines, two), (_, one) = [_finish_run_net(runs[n], tmp_path / f"x3d{n}") for n in (2, 1)]
    assert two == one and len(two) == 1
    assert sum("Saved checkpoint" in line for line in lines) == 1
    assert any("Updated precise BN stats" in line for line in lines)
    ckpts = [torch.load(tmp_path / f"x3d{n}" / "checkpoints" / "checkpoint_epoch_00001.pyth",
                        weights_only=True)["model_state"] for n in (2, 1)]
    params = [k for k, v in ckpts[1].items() if v.is_floating_point() and "running" not in k]
    assert sorted(ckpts[0]) == sorted(ckpts[1])
    assert _relative_l2({k: ckpts[0][k] for k in params}, {k: ckpts[1][k] for k in params}) < 1e-3


@pytest.mark.parametrize("kernel", ["forward", "wgrad"])
@pytest.mark.parametrize("elem", [2, 4], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [s for s, _ in dw.X3D_SP_DW_SHAPES + dw.X3D_SP_TEST_DW_SHAPES
                                   + dw.CSN_SP_DW_SHAPES])
def test_a_launch_plan_fits_each_halo_extended_shape(shape, elem, kernel):
    """X3D-M's rank holds 8 of 16 frames, ir-CSN-101's half of each stage's
    32, 16, 8 and 4 planes; each with a halo plane either side, C padded as
    the wrappers pad it. A grid of fewer blocks than the card's SMs has its
    T cut to single planes, the most the rule cuts (ir-CSN-101's last stage,
    2 x 4 x 7 x 7 x 512, in the bfloat16 weight gradient: 128 blocks)."""
    assert shape[1] in ((10,) if shape[-1] in (54, 108, 216, 432) else (18, 10, 6, 4))
    shape = (*shape[:-1], shape[-1] + -shape[-1] % dw.CHANNEL_MULTIPLE)
    plan = (dw.plan_forward if kernel == "forward" else dw.plan_wgrad)(shape, elem)
    _check_tiling(plan)
    _check_halo(plan)
    assert plan.smem_bytes <= dw.SMEM_PER_BLOCK
    assert plan.blocks >= dw.H100_SMS or plan.tt == 1
