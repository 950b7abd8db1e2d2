"""Temporal sequence parallelism of the port (TPU.SHARD_STRATEGY dp_sp,
``pmv_tpu_torch/parallel/mesh.py``) on the CPU.

- The halo arithmetic, in one process: each rank's conv or pool on its T
  slice extended by its halo planes, cut, tiles the conv on the whole T,
  forward and both gradients (the plain K1 version on the CPU for the
  stride-1 3x3x3 pool): the patch conv, a stride-1 3x3x3 pool, a
  (1, 8, 8)-strided K/V pool, and a max pool with a T kernel of 3. The
  collective is simulated: a rank's halo is cut from the whole clip, so
  that the gradients of the halo planes reach their owners. The temporal
  rel-pos table with a q offset gives the rows of the clip's table.
- The layout: the port's rank grid is the device grid of the JAX package's
  ``create_mesh`` for 2, 4, 6 and 8 processes (and TPU.MESH_SHAPE's), and
  an odd world falls back to dp as ``create_mesh`` does.
- The refusals: an SSL model, detection and multigrid under dp_sp raise
  NotImplementedError naming ROADMAP.md before ``run_net`` starts a
  process, and the SSL and detection models in ``wrap_model``; a rank's
  frames that the patch conv's T stride does not divide raise ValueError.
  UniFormer and Uniformerframe pass them.
- 4 ranks, a grid of data 2 x model 2, one spawn: the data groups' rows,
  MixUp's partner rows across them, and one train step of MViT and one of
  UniFormer (BatchNorm over the 4 ranks' planes) equal to the port's
  one-process step on the global batch.
- ``run_net`` with NUM_GPUS 2 and TPU.SHARD_STRATEGY dp_sp on the tiny
  yaml at 4 frames (2 token planes, one a rank): train, the gathered eval,
  one checkpoint written by rank 0, the test; its test_final equals one
  process's at the same global batch. The launch plans take a rank's
  MViTv2-S pool shapes and UniFormer-S DPE shapes under dp_sp (4 + 2 halo
  planes).
"""

import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _mvitv2_s_cfg
from pmv_tpu.parallel import mesh as jax_mesh
from pmv_tpu_torch.config import get_cfg
from pmv_tpu_torch.engine.steps import init_state, make_train_step
from pmv_tpu_torch.entry import mvitv2_s_cfg
from pmv_tpu_torch.models import build_model, common
from pmv_tpu_torch.models.attention import rel_q_table_temporal
from pmv_tpu_torch.models.stem import PatchEmbed
from pmv_tpu_torch.ops import depthwise as dw
from pmv_tpu_torch.ops.depthwise import record_shapes
from pmv_tpu_torch.parallel import distributed, mesh
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.utils import checkpoint as cu
from test_torch_port_depthwise import _check_halo, _check_tiling
from torch_port_util import (
    finish_run_net,
    free_port,
    join_ranks,
    port_cfg,
    rank_grid_case,
    start_ranks,
    start_run_net,
)

ROOT = Path(__file__).resolve().parents[1]
RANKS = 2  # the model axis of the simulated grid


def _simulate_rank(monkeypatch, clip, m):
    """Rank ``m`` of ``RANKS``'s T collectives over ``clip`` [B, T, ...]
    (the whole clip, which holds every rank's planes): a halo is cut from
    it, ``fill`` (zeros when None) beyond its ends, so that the backward
    takes each halo plane's gradient to the plane."""

    def extend_t(x, left, right, fill=None):
        t = x.shape[1]
        ends = [clip.new_full((clip.shape[0], n, *clip.shape[2:]), 0.0 if fill is None else fill)
                for n in (left, right)]
        padded = torch.cat([ends[0], clip, ends[1]], dim=1)
        return padded[:, m * t:m * t + left + t + right]

    monkeypatch.setattr(mesh, "_active", mesh.Layout(0, 1, m, RANKS))
    monkeypatch.setattr(mesh, "extend_t", extend_t)


def _depthwise(stride):
    w = torch.nn.Parameter(torch.randn(8, 1, 3, 3, 3, dtype=torch.float64,
                                       generator=torch.Generator().manual_seed(1)))
    return w, lambda x: common.channels_last_conv3d(x, w, None, stride, (1, 1, 1), groups=8)


def _case(name):
    """(the op on [B, T, H, W, C], its parameters, the clip)."""
    gen = torch.Generator().manual_seed(0)
    if name == "patch":  # (3, 7, 7) / (2, 4, 4), padded (1, 3, 3): one left halo frame
        conv = common.ChannelsLastConv3d(3, 8, (3, 7, 7), (2, 4, 4), (1, 3, 3)).double()
        return conv, list(conv.parameters()), torch.randn(2, 8, 16, 16, 3, dtype=torch.float64,
                                                          generator=gen)
    if name == "pool_k1":  # stride-1 3x3x3: K1's route, a halo plane each side
        w, op = _depthwise((1, 1, 1))
        return op, [w], torch.randn(2, 4, 6, 5, 8, dtype=torch.float64, generator=gen)
    if name == "kv_pool":  # MViTv2-S's first K/V pools: (3, 3, 3) / (1, 8, 8)
        w, op = _depthwise((1, 8, 8))
        return op, [w], torch.randn(2, 4, 16, 16, 8, dtype=torch.float64, generator=gen)
    op = lambda x: common.max_pool_3d(x, (3, 3, 3), (1, 2, 2), (1, 1, 1))  # noqa: E731
    return op, [], torch.randn(2, 4, 6, 6, 8, dtype=torch.float64, generator=gen) - 4.0


@pytest.mark.parametrize("name", ["patch", "pool_k1", "kv_pool", "max_pool"])
def test_halo_extended_slices_tile_the_whole_conv(monkeypatch, name):
    op, params, clip = _case(name)
    whole = clip.clone().requires_grad_()
    y = op(whole)
    cot = torch.randn(y.shape, dtype=y.dtype, generator=torch.Generator().manual_seed(2))
    want = torch.autograd.grad((y * cot).sum(), [whole] + params)

    sliced = clip.clone().requires_grad_()
    t = clip.shape[1] // RANKS
    outs = []
    with record_shapes() as shapes:
        for m in range(RANKS):
            with monkeypatch.context() as patch:
                _simulate_rank(patch, sliced, m)
                outs.append(op(sliced[:, m * t:(m + 1) * t]))
    out = torch.cat(outs, dim=1)
    torch.testing.assert_close(out, y, atol=1e-12, rtol=0)
    got = torch.autograd.grad((out * cot).sum(), [sliced] + params)
    for g, w in zip(got, want):  # dx, then dw: the ranks' partial sums added
        torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-12)
    if name == "pool_k1":  # K1 on each rank's 2 planes and its 2 halo planes
        assert shapes == [("fwd", (2, t + 2, 6, 5, 8))] * RANKS


@pytest.mark.parametrize("k_t", [4, 2])
def test_rel_pos_table_with_a_q_offset_gives_the_clips_rows(k_t):
    gen = torch.Generator().manual_seed(3)
    q_t, h, w, heads, c = 4, 3, 2, 2, 4
    q = torch.randn(2, 1 + q_t * h * w, heads, c, generator=gen)
    table = torch.randn(7, c, generator=gen)
    whole = rel_q_table_temporal(q, (q_t, h, w), (k_t, 2, 2), table, True)
    n = q_t // RANKS
    for m in range(RANKS):
        rows = slice(m * n * h * w, (m + 1) * n * h * w)
        q_m = torch.cat([q[:, :1], q[:, 1:][:, rows]], dim=1)
        got = rel_q_table_temporal(q_m, (n, h, w), (k_t, 2, 2), table, True, q_t, m * n)
        torch.testing.assert_close(got, whole[:, rows], atol=0, rtol=0)
        if m:  # the local q size alone gives other rows: the offset is needed
            alone = rel_q_table_temporal(q_m, (n, h, w), (k_t, 2, 2), table, True)
            assert not torch.allclose(alone, whole[:, rows])


def test_a_ranks_frames_must_be_a_multiple_of_the_patch_stride(monkeypatch):
    embed = PatchEmbed(3, 8, (3, 7, 7), (2, 4, 4), (1, 3, 3))
    clip = torch.zeros(1, 6, 16, 16, 3)
    _simulate_rank(monkeypatch, clip, 0)
    with pytest.raises(ValueError, match="a rank's 3 planes are not a multiple of the T stride 2"):
        embed(clip[:, :3])


def _jax_grid(n, *opts):
    cfg = _mvitv2_s_cfg(tiny=True)
    cfg.TPU.SHARD_STRATEGY = "dp_sp"
    cfg.merge_from_list(list(opts))
    devices = jax.devices()[:n]
    index = {d: i for i, d in enumerate(devices)}
    jm = jax_mesh.create_mesh(cfg, devices=devices)
    return cfg, np.vectorize(index.get)(jm.devices), jm.axis_names


@pytest.mark.parametrize("n, opts", [(2, ()), (4, ()), (6, ()), (8, ()),
                                     (8, ("TPU.MESH_SHAPE", [2, 4], "TPU.MESH_AXES",
                                          ["data", "model"]))])
def test_rank_grid_is_create_meshs_device_grid(n, opts):
    cfg, want, axes = _jax_grid(n, *opts)
    assert axes == ("data", "model")
    pcfg = port_cfg(cfg)
    size = mesh.model_size(pcfg, n)
    np.testing.assert_array_equal(mesh.grid(n, size), want)
    for rank in range(n):
        lay = mesh.layout_of(pcfg, rank, n)
        assert want[lay.data, lay.model] == rank
        assert (lay.data_size, lay.model_size) == want.shape


@pytest.mark.parametrize("n", [1, 3, 5, 7])
def test_an_odd_world_falls_back_to_dp(n):
    cfg, want, axes = _jax_grid(n)
    assert axes == ("data",) and want.shape == (n,)
    pcfg = port_cfg(cfg)
    assert mesh.model_size(pcfg, n) == 1
    assert [mesh.layout_of(pcfg, r, n) for r in range(n)] == [
        mesh.Layout(r, n, 0, 1) for r in range(n)]


def test_a_model_axis_runs_under_dp_sp_only():
    cfg = mvitv2_s_cfg(tiny=True)
    cfg.TPU.MESH_SHAPE, cfg.TPU.MESH_AXES = [2, 2], ["data", "model"]
    with pytest.raises(NotImplementedError, match="under dp_sp"):
        mesh.model_size(cfg, 4)


TINY_UNIFORMER = ("UNIFORMER.PRETRAIN_NAME", "", "UNIFORMER.EMBED_DIM", [8, 16, 16, 32],
                  "UNIFORMER.DEPTH", [1, 1, 1, 1], "UNIFORMER.HEAD_DIM", 8,
                  "TENSORBOARD.ENABLE", False)


TINY_SLOW = ("RESNET.DEPTH", 18, "RESNET.WIDTH_PER_GROUP", 4, "DATA.NUM_FRAMES", 4,
             "DATA.TRAIN_CROP_SIZE", 16, "DATA.TEST_CROP_SIZE", 16)


@pytest.mark.parametrize("path, opts, model_refused", [
    ("configs/contrastive_ssl/MoCo_SlowR50_8x8.yaml", TINY_SLOW, True),  # an SSL model
    ("configs/AVA/SLOW_8x8_R50_SHORT.yaml", TINY_SLOW, True),  # detection
    ("configs/tiny_multigrid_synthetic.yaml", (), False),  # multigrid, on SlowFast
    ("configs/tiny_maskfeat_synthetic.yaml", (), True),  # MaskMViT, an SSL model
])
def test_another_model_under_dp_sp_raises(path, opts, model_refused):
    """What dp_sp does not run raises NotImplementedError naming ROADMAP.md
    before ``run_net`` starts a process, and, for a model that it does not
    run (the SSL models, a detection model), in ``wrap_model``; the conv
    families run under it (tests/test_torch_port_sequence_parallel_conv.py),
    but not with multigrid."""
    cfg = get_cfg()
    cfg.merge_from_file(path)
    cfg.merge_from_list(list(opts))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    if model_refused:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            distributed.wrap_model(model, "dp_sp", torch.device("cpu"))
    else:
        assert type(model).__name__ in distributed.SEQUENCE_PARALLEL_MODELS
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):  # before any process starts
        run_net.main(["--cfg", path, "--device", "cpu", "--opts", *map(str, opts),
                      "NUM_GPUS", "2", "TPU.SHARD_STRATEGY", "dp_sp"])


@pytest.mark.parametrize("name", ["Uniformer", "Uniformerframe"])
def test_uniformer_runs_under_dp_sp(name):
    """UniFormer and its frame-based variant pass the dp_sp refusals, and
    their 1x1-in-T patch embeds (every stage of Uniformerframe, stages 2-4
    of Uniformer) take no halo."""
    cfg = get_cfg()
    cfg.merge_from_file("configs/Kinetics/UNIFORMER_S_16x4.yaml")
    cfg.merge_from_list([*TINY_UNIFORMER, "MODEL.MODEL_NAME", name, "UNIFORMER.FRAME_BASE",
                         name == "Uniformerframe", "NUM_GPUS", 2, "TPU.SHARD_STRATEGY", "dp_sp"])
    distributed.refuse_sequence_parallel(cfg)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    assert type(model).__name__ in distributed.SEQUENCE_PARALLEL_MODELS
    kernels = [model.patch_embed1.proj.kernel_size[0]] + [
        getattr(model, f"patch_embed{i}").proj.kernel_size[0] for i in (2, 3, 4)]
    assert kernels == ([1] * 4 if name == "Uniformerframe" else [3, 1, 1, 1])


def _grid_cfg():
    cfg = mvitv2_s_cfg(tiny=True)
    cfg.DATA.NUM_FRAMES = 8
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.AUG.ENABLE = True
    cfg.AUG.AA_TYPE = "rand-m7-n1-mstd0.5-inc1"
    cfg.AUG.RE_PROB = 0.5
    # The token mean over the model group and the absolute position
    # embedding at a rank's T offset, which MViTv2-S leaves off.
    cfg.MVIT.USE_MEAN_POOLING = True
    cfg.MVIT.USE_ABS_POS = True
    cfg.TPU.SHARD_STRATEGY = "dp_sp"
    return cfg


def _grid_uniformer_cfg():
    """Tiny UniFormer at 8 frames (2 token planes a rank after the stride-2
    patch embed), BatchNorm's statistics over the 4 ranks' (rows, planes),
    DropPath on."""
    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / "configs" / "Kinetics" / "UNIFORMER_S_16x4.yaml"))
    cfg.merge_from_list([*TINY_UNIFORMER, "DATA.NUM_FRAMES", 8, "DATA.TRAIN_CROP_SIZE", 32,
                         "UNIFORMER.DROP_DEPTH_RATE", 0.5, "AUG.ENABLE", True, "AUG.AA_TYPE",
                         "rand-m7-n1-mstd0.5-inc1", "AUG.RE_PROB", 0.5, "NUM_GPUS", 1,
                         "TPU.SHARD_STRATEGY", "dp_sp"])
    return cfg


def _grid_case(cfg, seed):
    """The port's seeded model, a global batch of 4 and its draws."""
    rng = np.random.default_rng(seed)
    size = cfg.DATA.TRAIN_CROP_SIZE
    batch = {"frames": rng.integers(0, 256, (4, 8, size, size, 3), np.uint8),
             "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, 4)}
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=seed + 1)
    draws = make_train_step(cfg, device="cpu").sample_draws(model, batch["frames"].shape)
    return model, {"cfg": cfg, "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
                   "batch": batch, "draws": draws, "lr": 1e-3}


@pytest.fixture(scope="module")
def grid_ranks(tmp_path_factory):
    """MViT's and UniFormer's dp_sp steps on 4 ranks, a grid of data 2 x model
    2, one spawn; each one-process step on the global batch, computed here
    while the ranks run."""
    case_dir = tmp_path_factory.mktemp("grid")
    models, cases = {}, {}
    for name, cfg, seed in (("mvit", _grid_cfg(), 4), ("uniformer", _grid_uniformer_cfg(), 6)):
        models[name], cases[name] = _grid_case(cfg, seed)
    torch.save(cases, case_dir / "grid_case.pt")
    procs = start_ranks(rank_grid_case, str(case_dir), world=4,
                        model_size=mesh.model_size(cases["mvit"]["cfg"], 4))
    try:
        refs = {}
        for name, case in cases.items():
            model = models[name]
            metrics = make_train_step(case["cfg"], device="cpu")(
                init_state(case["cfg"], model), case["batch"], case["lr"], case["draws"])
            refs[name] = (metrics, {k: p.grad.clone() for k, p in model.named_parameters()},
                          model.state_dict())
    finally:
        join_ranks(procs)
    return torch.load(case_dir / "grid_results.pt", weights_only=False), refs


def _assert_grid_step(got, ref, skip=()):
    metrics, grads, state = ref
    for key in ("loss", "grad_norm", "top1_err", "top5_err"):
        np.testing.assert_allclose(got["metrics"][key], float(metrics[key]), rtol=1e-5,
                                   err_msg=key)
    diff = sum(float((got["grads"][k] - g).square().sum()) for k, g in grads.items())
    assert (diff / sum(float(g.square().sum()) for g in grads.values())) ** 0.5 < 1e-5
    for key, value in state.items():
        if not key.endswith(skip):
            torch.testing.assert_close(got["state"][key], value, atol=1e-5, rtol=0, msg=key)


def test_a_2x2_grid_step_equals_one_process(grid_ranks):
    """Data groups {0, 2} and {1, 3}, model groups {0, 1} and {2, 3}; each
    model group holds 2 of the global batch's 4 rows (MixUp mixing them
    with the other group's, reversed), each rank half of their planes; the
    head pools the tokens' mean."""
    got, refs = grid_ranks
    layouts, data_axis, partners = got["ranks"]
    assert layouts == [[0, 2, 0, 2], [0, 2, 1, 2], [1, 2, 0, 2], [1, 2, 1, 2]]
    assert data_axis == [[0.0, 2.0], [1.0, 3.0], [0.0, 2.0], [1.0, 3.0]]
    assert partners == [2.0, 3.0, 0.0, 1.0]
    # MViT's key-norm bias: float noise that Adam scales to +-lr.
    _assert_grid_step(got["steps"]["mvit"], refs["mvit"], skip=("norm_k.bias",))


def test_a_2x2_grid_uniformer_step_equals_one_process(grid_ranks):
    """UniFormer on the same grid: BatchNorm's statistics over 4 ranks,
    each holding its (rows, planes); K and V gathered over the model group;
    the feature mean summed over it."""
    got, refs = grid_ranks
    # The last block's fc2 bias reaches the loss only as a per-channel shift
    # into the final BatchNorm: its gradient is float noise, as
    # tests/test_torch_port_uniformer_train.py finds.
    _assert_grid_step(got["steps"]["uniformer"], refs["uniformer"],
                      skip=("blocks4.0.mlp.fc2.bias",))


@pytest.mark.parametrize("kernel", ["forward", "wgrad"])
@pytest.mark.parametrize("elem", [2, 4], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [s for s, _ in dw.MVIT_SP_POOL_SHAPES + dw.MVIT_SP_SQUARE_POOL_SHAPES
                                   + dw.UNIFORMER_SP_DPE_SHAPES
                                   + dw.UNIFORMER_SP_TEST_DPE_SHAPES])
def test_a_launch_plan_fits_each_halo_extended_shape(shape, elem, kernel):
    assert shape[1] == 6
    plan = (dw.plan_forward if kernel == "forward" else dw.plan_wgrad)(shape, elem)
    _check_tiling(plan)
    _check_halo(plan)
    assert plan.smem_bytes <= dw.SMEM_PER_BLOCK and plan.blocks >= dw.H100_SMS


def _start_run_net(out, nproc, *opts, cfg="tiny_synthetic.yaml"):
    """run_net on ``cfg`` (the tiny yaml by default) at 4 clips a step, in
    ``nproc`` processes (``start_run_net``)."""
    return start_run_net([
        "--cfg", str(ROOT / "configs" / cfg), "--device", "cpu", "--init_method",
        f"tcp://127.0.0.1:{free_port()}", "--opts", "OUTPUT_DIR", str(out), "NUM_GPUS",
        str(nproc), "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "4",
        "DATA_LOADER.NUM_WORKERS", "2", *opts])


def _finish_run_net(proc, out):
    """Wait for ``proc`` (``finish_run_net``); its log's lines and
    test_final stats."""
    finish_run_net(proc)
    lines = (out / "stdout.log").read_text().splitlines()
    return lines, [json.loads(line.split("json_stats: ", 1)[1]) for line in lines
                   if "json_stats: " in line and "test_final" in line]


# Tiny UniFormer with the PMV rect recipe's crop options, at 8 frames (2 + 2
# token planes), one clip a video, one test view, one epoch.
UNIFORMER_RUN = ("--cfg", "Kinetics/UNIFORMER_S_16x4.yaml", *TINY_UNIFORMER,
                 "DATA.NUM_FRAMES", 8, "DATA.TRAIN_CROP_SIZE", 32, "DATA.TEST_CROP_SIZE", 32,
                 "DATA.TRAIN_CROP_SIZE_RECT", [48, 32], "DATA.TRAIN_JITTER_SCALES", [32, 40],
                 "DATA.TRAIN_JITTER_SCALES_RELATIVE", [],
                 "DATA.TRAIN_JITTER_ASPECT_RELATIVE", [],
                 "DATA.TRAIN_JITTER_SCALES_AUTO_ADJUST", True, "TRAIN.DATASET", "synthetic",
                 "TEST.DATASET", "synthetic", "TRAIN.MIXED_PRECISION", False,
                 "AUG.NUM_SAMPLE", 1, "TEST.NUM_ENSEMBLE_VIEWS", 1,
                 "TEST.NUM_SPATIAL_CROPS", 1, "SOLVER.MAX_EPOCH", 1)


def _uniformer_run(out, nproc, *opts):
    cfg, opts_all = UNIFORMER_RUN[1], [str(o) for o in UNIFORMER_RUN[2:] + opts]
    return _start_run_net(out, nproc, *opts_all, cfg=cfg)


@pytest.fixture(scope="module")
def run_nets(tmp_path_factory):
    """run_net under dp_sp with NUM_GPUS 2 and in one process: the tiny MViT
    at 4 frames (2 token planes, one a rank) and tiny UniFormer, all four
    at once; then UniFormer's 2 processes again with SOLVER.MAX_EPOCH 2."""
    root = tmp_path_factory.mktemp("run_nets")
    runs = {
        ("mvit", 2): _start_run_net(root / "mvit2", 2, "DATA.NUM_FRAMES", "4",
                                    "TPU.SHARD_STRATEGY", "dp_sp"),
        ("mvit", 1): _start_run_net(root / "mvit1", 1, "DATA.NUM_FRAMES", "4"),
        ("uniformer", 2): _uniformer_run(root / "uniformer2", 2, "TPU.SHARD_STRATEGY", "dp_sp"),
        ("uniformer", 1): _uniformer_run(root / "uniformer1", 1),
    }
    out = {key: _finish_run_net(proc, root / f"{key[0]}{key[1]}") for key, proc in runs.items()}
    resumed = _uniformer_run(root / "uniformer2", 2, "TPU.SHARD_STRATEGY", "dp_sp",
                             "SOLVER.MAX_EPOCH", "2")
    out["uniformer", "resumed"] = _finish_run_net(resumed, root / "uniformer2")
    return root, out


def test_run_net_under_dp_sp_equals_one_process(run_nets):
    """... and its checkpoint resumes in one process under dp, every weight
    and AdamW tensor as written."""
    root, out = run_nets
    (lines, two), (_, one) = out["mvit", 2], out["mvit", 1]
    assert two == one and len(two) == 1
    assert sum("Saved checkpoint" in line for line in lines) == 1
    path = root / "mvit2" / "checkpoints" / "checkpoint_epoch_00001.pyth"
    assert os.listdir(path.parent) == [path.name]

    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / "configs" / "tiny_synthetic.yaml"))
    cfg.merge_from_list(["DATA.NUM_FRAMES", 4, "OUTPUT_DIR", str(root / "mvit2")])
    state = init_state(cfg, build_model(cfg, device="cpu", dtype=torch.float32))
    assert cu.load_train_checkpoint(cfg, state) == 1
    ckpt = torch.load(path, weights_only=True)
    for key, value in state.model.state_dict().items():
        assert torch.equal(value, ckpt["model_state"][key]), key
    opt = state.optimizer.state_dict()["state"]
    for i, entries in ckpt["optimizer_state"]["state"].items():
        for key, value in entries.items():
            assert torch.equal(opt[i][key], value), (i, key)


def test_run_net_uniformer_under_dp_sp_equals_one_process_and_resumes(run_nets):
    """UniFormer under dp_sp with NUM_GPUS 2 (the rect crop, BatchNorm's
    statistics over both ranks' planes, the gathered eval, the test of
    model rank 0's clips): one process's test_final and weights; one
    checkpoint, written by rank 0; a second call resumes from it."""
    root, out = run_nets
    (lines, two), (_, one) = out["uniformer", 2], out["uniformer", 1]
    assert two == one and len(two) == 1
    assert sum("Saved checkpoint" in line for line in lines) == 1
    ckpts = [torch.load(root / d / "checkpoints" / "checkpoint_epoch_00001.pyth",
                        weights_only=True)["model_state"] for d in ("uniformer2", "uniformer1")]
    for key, value in ckpts[1].items():
        torch.testing.assert_close(ckpts[0][key], value, atol=1e-5, rtol=1e-5, msg=key)
    lines, final = out["uniformer", "resumed"]
    assert any("Load from last checkpoint" in line for line in lines)
    assert any("Start epoch: 2" in line for line in lines) and len(final) == 2
    assert sorted(os.listdir(root / "uniformer2" / "checkpoints")) == [
        "checkpoint_epoch_00001.pyth", "checkpoint_epoch_00002.pyth"]
