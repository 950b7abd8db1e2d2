"""Temporal sequence parallelism (TPU.SHARD_STRATEGY dp_sp) of the tasks
beyond classification on the CPU: MaskFeat and the contrastive models, AVA
detection, feature extraction and multigrid.

One spawn of 2 ranks over gloo (``rank_task_cases``), a grid of data 1 x
model 2, each rank the whole global batch; a collective that still ran over
the world instead of the data group would count every row twice:

- tiny MaskMViT with a decoder block (MASK.DECODER_DEPTH 1; 4 frames, 2 a
  rank, one token plane), the PT recipe's AdamW step: with the loader's
  masks of unequal counts against the JAX package's global step (JAX's HOG
  bins held; float32 atol 2e-4 / rtol 1e-4, the gradients to a relative L2
  of 1e-4), and with the model's own draw against one process, also with
  MVIT.DROPOUT_RATE 0.1 (the keep masks drawn for the global batch's clips,
  each rank's forward taking its token planes of them); K1 on each
  rank's 1 + 2 token planes, K and V gathered in the backbone and the
  decoder;
- MoCo and SimCLR on the tiny Slow (the views whole on every rank, float64
  activations) against one process: the queue takes 4 keys, not 8, SimCLR
  2 x 4 negatives;
- AVA SlowFast and Slow detection (8 frames, 4 a rank, the slow pathway 1;
  3 and 1 valid boxes in the 2 clips; float64) against the JAX package's
  global step, as tests/test_torch_port_detection.py holds one process;
  the eval scores and, for SlowFast on an AVA dump, ``test_detection``'s
  mAP (model rank 0's boxes) against one process;
- ``extract_features`` of tiny MViT (8 frames, the cls token whole on each
  rank) on the Synthetic test split against one process;
- multigrid SlowFast (the tiny multigrid yaml at 16 frames and ALPHA 2): the
  first long cycle's shape (4 frames, 2 a rank, sub_batchnorm) and then a
  short-cycle batch, 2 x its rows at the short crop, through the same
  SubBatchNorms, against one process in float64 (weights too: the second
  step starts from the first's update).

Then ``run_net`` on the tiny MaskFeat yaml with NUM_GPUS 2 under dp_sp
against one process, and its resume; what ``check`` refuses before any
process starts (a long cycle whose frames the model axis cannot cut); the
launch plans at MaskFeat PT's dp_sp shapes.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_contrastive_train as ct_train
import test_torch_port_detection as det_test
import test_torch_port_maskfeat_train as mf_train
from pmv_tpu.engine import ssl_steps as jssl
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine.train_state import TrainState
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models import optimizer as joptim
from pmv_tpu_torch.config import get_cfg
from pmv_tpu_torch.data.loader import short_cycle_factors
from pmv_tpu_torch.engine import ssl_steps
from pmv_tpu_torch.entry import mvitv2_s_cfg
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.ops import depthwise as dw
from pmv_tpu_torch.parallel import mesh
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.tools.ava_dump import write_ava_dump
from pmv_tpu_torch.utils.multigrid import MultigridSchedule, short_cycle_crop_size
from pmv_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax
from test_torch_port_depthwise import _check_halo, _check_tiling
from test_torch_port_sequence_parallel import ROOT, _finish_run_net, _start_run_net
from torch_port_util import (
    jax_hog_bins,
    join_ranks,
    numpy_tree,
    port_cfg,
    rank_task_cases,
    start_ranks,
    task_case,
)

RANKS = 2  # the model axis
ATOL, RTOL = 2e-4, 1e-4  # float32 against JAX, as the one-process files hold it
MASK_P = np.array([0.45, 0.1])  # the loader's masks: 58 and 13 of 128 tokens


def _dp_sp(cfg):
    cfg.TPU.SHARD_STRATEGY = "dp_sp"
    return cfg


def _relative_l2(got, want):
    diff = sum(float((got[k].double() - v.double()).square().sum()) for k, v in want.items())
    return (diff / sum(float(v.double().square().sum()) for v in want.values())) ** 0.5


# ------------------------------------------------------------ the cases


def _maskfeat_cases():
    """The masked step with the loader's masks (and the JAX global step's
    reference, a thunk), and with the model's own draw."""
    cfg = mf_train._step_cfg()
    cfg.MASK.DECODER_DEPTH = 1
    cfg.MASK.DEC_KV_KERNEL, cfg.MASK.DEC_KV_STRIDE = [3, 3, 3], [1, 2, 2]
    batch = mf_train._batch(2, 32, 0)
    batch["mask"] = np.random.default_rng(1).uniform(size=(2, 128)) < MASK_P[:, None]
    jmodel, params = mf_train._jax_model_and_params(cfg)
    tx = joptim.construct_optimizer(params, cfg)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                        opt_state=tx.init(params))
    jstep = jssl.make_masked_train_step(cfg, jmodel, tx)
    preprocess = jsteps.make_preprocess_fn(cfg, train=True)
    rng = jax.random.PRNGKey(3)

    def step_and_input(state, batch):
        k_pre = jax.random.split(jax.random.fold_in(rng, 0), 3)[0]
        return jstep(state, batch, rng, mf_train.LR), preprocess(k_pre, batch["frames"])

    (jnew, jm), x = jax.jit(step_and_input)(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state_dict = state_dict_from_jax(numpy_tree(params))
    pcfg = _dp_sp(port_cfg(cfg))
    loader = {"cfg": pcfg, "state_dict": state_dict, "batch": batch, "lr": mf_train.LR,
              "draws": {"hog_bins": torch.tensor(jax_hog_bins(x))}}
    drawn = {"cfg": pcfg, "state_dict": state_dict, "lr": mf_train.LR,
             "batch": {"frames": batch["frames"]}}
    dropout_cfg = pcfg.clone()
    dropout_cfg.MVIT.DROPOUT_RATE = 0.1
    dropout = dict(drawn, cfg=dropout_cfg)

    def reference():
        b1 = cfg.SOLVER.BETAS[0]
        clip = min(1.0, cfg.SOLVER.CLIP_GRAD_L2NORM / float(jm["grad_norm"]))
        grads = state_dict_from_jax(jax.tree_util.tree_map(
            lambda mu: np.asarray(mu, np.float64) / ((1 - b1) * clip),
            mf_train._adam_first_moment(jnew)))
        return {"metrics": [{k: float(v) for k, v in jm.items()}], "grads": grads,
                "state": state_dict_from_jax(numpy_tree(jnew.params))}

    return loader, drawn, dropout, reference


def _contrastive_case(ssl_type):
    cfg = _dp_sp(port_cfg(ct_train.step_cfg(ssl_type)))
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=2)
    return {"cfg": cfg, "state_dict": model.state_dict(), "dtype": torch.float64,
            "lr": ct_train.LR, "batch": {"frames": ct_train._frames(2),
                                         "index": ct_train.INDEX}}


def _detection_case(name, root):
    """Tiny AVA ``name`` at 80 classes, no head dropout, float64 weights and
    activations, its global batch of 2 clips (3 and 1 valid boxes), eval
    clips; SlowFast's config points at the dump under ``root`` for
    ``test_detection``. With the JAX global step's reference (a thunk)."""
    opts = ("MODEL.NUM_CLASSES", "80", "MODEL.DROPOUT_RATE", "0.0", "TEST.BATCH_SIZE", "2")
    if name == "slowfast":
        opts += ("AVA.FRAME_DIR", str(root / "frames"), "AVA.FRAME_LIST_DIR",
                 str(root / "frame_lists"), "AVA.ANNOTATION_DIR", str(root / "annotations"))
    cfg = det_test.tiny_cfg(name, *opts)
    batch = det_test._batch(2, classes=80)
    variables = det_test._variables(name, cfg, jax_build_model(cfg, dtype=jnp.float32), 4,
                                    np.float64)
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float64)
    model.double()
    load_jax_params(model, variables)
    case = {"cfg": _dp_sp(port_cfg(cfg)), "state_dict": model.state_dict(),
            "dtype": torch.float64, "double": True, "lr": det_test.LR, "batches": [batch],
            "eval": det_test._batch(5, classes=80), "test_detection": name == "slowfast"}

    def reference():
        with jax.enable_x64(True):
            jmodel = jax_build_model(cfg, dtype=jnp.float64)
            tx = joptim.construct_optimizer(variables["params"], cfg)
            jstate = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                batch_stats=variables["batch_stats"],
                                opt_state=tx.init(variables["params"]))
            jstate, jm = jax.jit(jsteps.make_detection_train_step(cfg, jmodel, tx))(
                jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                jax.random.PRNGKey(0), det_test.LR)
            return {"metrics": [{k: float(v) for k, v in jm.items()}],
                    "state": state_dict_from_jax(numpy_tree(
                        {"params": jstate.params, "batch_stats": jstate.batch_stats}))}

    return case, reference


def _feature_case(out):
    cfg = mvitv2_s_cfg(tiny=True)
    cfg.DATA.NUM_FRAMES = 8
    cfg.TEST.DATASET = "synthetic"
    cfg.TEST.BATCH_SIZE = 16
    cfg.TEST.NUM_ENSEMBLE_VIEWS = cfg.TEST.NUM_SPATIAL_CROPS = 1
    cfg.TEST.FEAT_EXTRACT = True
    cfg.DATA_LOADER.NUM_WORKERS = 1
    cfg.OUTPUT_DIR = str(out)
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=3)
    return {"cfg": _dp_sp(cfg), "state_dict": model.state_dict(), "features": True}


MULTIGRID_OPTS = ["DATA.NUM_FRAMES", "16", "SLOWFAST.ALPHA", "2", "NUM_GPUS", "2",
                  "TPU.SHARD_STRATEGY", "dp_sp"]


def _multigrid_cfg(*opts):
    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / "configs" / "tiny_multigrid_synthetic.yaml"))
    cfg.merge_from_list(MULTIGRID_OPTS + list(opts))
    return cfg


def _multigrid_case():
    """The first long cycle of the tiny multigrid yaml at 16 frames (4
    frames x crop 23 x 16 clips a step, sub_batchnorm of 4 splits over the
    job's 2 processes), a step at its shape and then a step on a short-cycle
    batch of phase 0 (2 x the clips at a smaller crop), in float64
    activations and weights."""
    cfg = _multigrid_cfg()
    schedule = MultigridSchedule()
    cfg = schedule.init_multigrid(cfg)
    schedule.update_long_cycle(cfg, 0)
    rng = np.random.default_rng(9)

    def batch(clips, crop):
        return {"frames": rng.integers(0, 256, (clips, cfg.DATA.NUM_FRAMES, crop, crop, 3),
                                       np.uint8),
                "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, clips)}

    f0, _ = short_cycle_factors(cfg)
    b = cfg.TRAIN.BATCH_SIZE
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=5)
    return {"cfg": cfg, "state_dict": model.state_dict(), "dtype": torch.float64,
            "double": True, "lr": 0.05, "batches": [batch(b, cfg.DATA.TRAIN_CROP_SIZE),
                        batch(b * f0, short_cycle_crop_size(0, cfg))]}


JAX_CASES = ("maskfeat_loader", "det_slowfast", "det_slow")
PORT_CASES = ("maskfeat_draw", "maskfeat_dropout", "moco", "simclr", "features", "multigrid")


@pytest.fixture(scope="module")
def task_ranks(tmp_path_factory):
    """Every case through ``rank_task_cases`` on 2 ranks; the JAX global
    steps and the one-process runs computed here while the ranks run (the
    JAX steps, each compiled once, beside the port's)."""
    case_dir = tmp_path_factory.mktemp("sp_tasks")
    root = case_dir / "ava"
    write_ava_dump(str(root), videos=2, frames=90, width=64, height=48, seed=2)
    cases, references = {}, {}
    (cases["maskfeat_loader"], cases["maskfeat_draw"], cases["maskfeat_dropout"],
     references["maskfeat_loader"]) = _maskfeat_cases()
    for name in ("moco", "simclr"):
        cases[name] = _contrastive_case(name)
    for name in ("slowfast", "slow"):
        cases[f"det_{name}"], references[f"det_{name}"] = _detection_case(name, root)
    cases["features"] = _feature_case(case_dir / "features")
    cases["multigrid"] = _multigrid_case()
    torch.save(cases, case_dir / "task_cases.pt")
    procs = start_ranks(rank_task_cases, str(case_dir), model_size=RANKS)
    try:
        with ThreadPoolExecutor(2) as pool:
            futures = {name: pool.submit(task_case, cases[name]) for name in cases}
            refs = {f"{name}_jax": reference() for name, reference in references.items()}
            refs.update({name: future.result() for name, future in futures.items()})
    finally:
        join_ranks(procs)
    return torch.load(case_dir / "task_results.pt", weights_only=False), refs, cases


def _assert_equals_one_process(got, one, rtol=1e-6, grad_l2=1e-6, atol=1e-6):
    for step, want in zip(got["metrics"], one["metrics"], strict=True):
        for key, value in want.items():
            np.testing.assert_allclose(step[key], value, rtol=rtol, atol=1e-9, err_msg=key)
        assert not step["nan"]
    assert set(got["grads"]) == set(one["grads"])
    assert _relative_l2(got["grads"], one["grads"]) < grad_l2
    for key, value in one["state"].items():
        torch.testing.assert_close(got["state"][key], value, atol=atol, rtol=rtol, msg=key)


def test_maskfeat_dp_sp_step_with_the_loaders_masks_matches_jax(task_ranks):
    """The loss divides by the global count of masked tokens (71), which
    the two ranks' planes share unequally."""
    results, refs, cases = task_ranks
    ref, before = refs["maskfeat_loader_jax"], cases["maskfeat_loader"]["state_dict"]
    for rank, got in enumerate(results["maskfeat_loader"]):
        assert got["layout"] == mesh.Layout(0, 1, rank, RANKS)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][0][key], ref["metrics"][0][key],
                                       atol=ATOL, rtol=RTOL, err_msg=key)
        assert _relative_l2(got["grads"], {k: v.float() for k, v in ref["grads"].items()}) < 1e-4
        for key, value in ref["state"].items():
            np.testing.assert_allclose(got["state"][key].numpy(), value.numpy(), atol=ATOL,
                                       rtol=RTOL, err_msg=key)
            assert torch.equal(got["state"][key], before[key]) == torch.equal(value, before[key])
    mask = cases["maskfeat_loader"]["batch"]["mask"]
    assert mask[:, :64].sum() != mask[:, 64:].sum()  # the ranks' planes hold unequal counts


def test_maskfeat_dp_sp_step_with_its_own_draw_equals_one_process(task_ranks):
    results, refs, _ = task_ranks
    for got in results["maskfeat_draw"]:
        _assert_equals_one_process(got, refs["maskfeat_draw"], rtol=1e-5, grad_l2=1e-5,
                                   atol=1e-6)


def test_maskfeat_dp_sp_dropout_masks_cut_to_a_ranks_planes_equal_one_process(task_ranks):
    """MVIT.DROPOUT_RATE 0.1 in the backbone: the step draws the keep masks
    for the global batch's clips, and each rank's forward takes its token
    planes of them (``mesh.local_planes``)."""
    results, refs, cases = task_ranks
    case = cases["maskfeat_dropout"]
    model = build_model(case["cfg"], device="cpu", dtype=torch.float32)
    draws = ssl_steps.make_masked_train_step(case["cfg"], device="cpu").sample_draws(
        model, case["batch"]["frames"].shape)
    assert draws["dropout_masks"] is not None
    for got in results["maskfeat_dropout"]:
        _assert_equals_one_process(got, refs["maskfeat_dropout"], rtol=1e-5, grad_l2=1e-5,
                                   atol=1e-6)
    assert refs["maskfeat_dropout"]["metrics"][0]["loss"] != refs["maskfeat_draw"]["metrics"][0][
        "loss"]


def test_maskfeat_dp_sp_runs_k1_on_halo_extended_token_planes(task_ranks):
    """The backbone's stride-1 q pool (block 0) takes its 3x3x3 depthwise
    conv on a rank's token plane and a halo plane either side (the
    decoder's KV pool is strided); the backbone's and the decoder's K and V
    are gathered over T."""
    results, _, _ = task_ranks
    for name in ("maskfeat_loader", "maskfeat_draw"):
        for got in results[name]:
            kinds = [kind for kind, _ in got["shapes"]]
            assert [kinds.count(k) for k in ("fwd", "dx", "wgrad")] == [1, 1, 1], kinds
            assert {shape[1] for _, shape in got["shapes"]} == {3}
            assert got["traffic"]["halo"] > 0 and got["traffic"]["gather"] > 0


@pytest.mark.parametrize("name", ["moco", "simclr"])
def test_contrastive_dp_sp_step_equals_one_process(task_ranks, name):
    """The views stay whole on each rank: no T collective runs, and the
    gathers, the queue's keys and the loss's mean run over the data group
    of one rank."""
    results, refs, _ = task_ranks
    for got in results[name]:
        _assert_equals_one_process(got, refs[name])
        assert got["traffic"] == {"halo": 0, "gather": 0, "reduce": 0}
        assert got["shapes"] == []
    if name == "moco":
        assert int(results[name][0]["state"]["queue_ptr"]) == 4


@pytest.mark.parametrize("name", ["slowfast", "slow"])
def test_detection_dp_sp_step_matches_jax_on_the_global_batch(task_ranks, name):
    results, refs, cases = task_ranks
    ref, before = refs[f"det_{name}_jax"], cases[f"det_{name}"]["state_dict"]
    one = refs[f"det_{name}"]
    for got in results[f"det_{name}"]:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][0][key], ref["metrics"][0][key],
                                       rtol=1e-4, err_msg=key)
        names = [k for k in ref["state"] if "running" not in k
                 and not k.endswith("num_batches_tracked")]
        assert _relative_l2({k: before[k] - got["state"][k] for k in names},
                            {k: before[k] - ref["state"][k] for k in names}) < 1e-4
        for key in set(ref["state"]) - set(names):
            if not key.endswith("num_batches_tracked"):
                np.testing.assert_allclose(got["state"][key].numpy(), ref["state"][key].numpy(),
                                           rtol=1e-4, atol=2e-5, err_msg=key)
        _assert_equals_one_process(got, one)
        torch.testing.assert_close(got["scores"], one["scores"], atol=1e-9, rtol=1e-9)
        assert got["traffic"]["reduce"] > 0  # the RoI head's mean over T
    if name == "slowfast":
        for got in results["det_slowfast"]:
            assert 0.0 < one["map"] <= 1.0
            np.testing.assert_allclose(got["map"], one["map"], atol=1e-9, rtol=0)


def test_extract_features_under_dp_sp_equals_one_process(task_ranks):
    """Each clip's pooled features (the cls token once, the planes' tokens
    summed over the model group) once, in the loader's order."""
    results, refs, _ = task_ranks
    one = refs["features"]["features"]
    assert one["features"].shape == (64, 16)
    for got in results["features"]:
        np.testing.assert_array_equal(got["features"]["index"], one["index"])
        np.testing.assert_allclose(got["features"]["features"], one["features"], atol=1e-6,
                                   rtol=1e-5)
        assert got["traffic"]["halo"] > 0 and got["traffic"]["gather"] > 0


def test_multigrid_long_and_short_cycle_steps_under_dp_sp_equal_one_process(task_ranks):
    """SubBatchNorm's split moments over the rows of the data group and
    both ranks' planes: the statistics (4 x C values a norm) and the step
    equal one process's at the long cycle's shape and on the short cycle's
    batch of 2 x the clips."""
    results, refs, cases = task_ranks
    cfg = cases["multigrid"]["cfg"]
    assert (cfg.DATA.NUM_FRAMES, cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS) == (4, "sub_batchnorm", 4)
    assert [b["frames"].shape[0] for b in cases["multigrid"]["batches"]] == [16, 32]
    for got in results["multigrid"]:
        _assert_equals_one_process(got, refs["multigrid"])
        assert got["traffic"]["halo"] > 0


def test_check_refuses_a_long_cycle_the_model_axis_cannot_cut():
    """At 8 frames and ALPHA 4 the first long cycle gives a rank 1 frame:
    ``run_net`` raises before any process starts, naming the cycle; at 16
    frames and ALPHA 2 it passes; so does every frame count under dp."""
    with pytest.raises(ValueError, match=r"the long cycle's frames \(crop 23, until epoch"):
        run_net.check(_multigrid_cfg("DATA.NUM_FRAMES", "8", "SLOWFAST.ALPHA", "4"))
    run_net.check(_multigrid_cfg())
    run_net.check(_multigrid_cfg("DATA.NUM_FRAMES", "6", "TPU.SHARD_STRATEGY", "dp"))


@pytest.mark.parametrize("kernel", ["forward", "wgrad"])
@pytest.mark.parametrize("elem", [2, 4], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [s for s, _ in dw.MASKFEAT_SP_POOL_SHAPES])
def test_a_launch_plan_fits_each_maskfeat_dp_sp_shape(shape, elem, kernel):
    """MaskFeat PT's 14 q-pools on a rank's 4 + 2 of 8 token planes at
    224^2, batch 2 and 4: the rule's plan tiles the grid, reads its halo
    and fills the card."""
    assert shape[1] == 6 and shape[-1] in (96, 192, 384, 768)
    plan = (dw.plan_forward if kernel == "forward" else dw.plan_wgrad)(shape, elem)
    _check_tiling(plan)
    _check_halo(plan)
    assert plan.smem_bytes <= dw.SMEM_PER_BLOCK and plan.blocks >= dw.H100_SMS


def _checkpoint(out, epoch):
    return torch.load(out / "checkpoints" / f"ssl_checkpoint_epoch_{epoch:05d}.pyth",
                      weights_only=True)["model_state"]


def test_run_net_maskfeat_under_dp_sp_equals_one_process_and_resumes(tmp_path):
    """Tiny MaskFeat PT, 64 videos at 4 a step, the model's own masks: the
    2-process dp_sp run's weights after the epoch within a relative L2 of
    1e-4 of one process's; a second call with SOLVER.MAX_EPOCH 2 resumes."""
    runs = {n: _start_run_net(tmp_path / f"mf{n}", n, "TPU.SHARD_STRATEGY", "dp_sp",
                              cfg="tiny_maskfeat_synthetic.yaml") for n in (2, 1)}
    for n in (2, 1):
        _finish_run_net(runs[n], tmp_path / f"mf{n}")
    two, one = (_checkpoint(tmp_path / f"mf{n}", 1) for n in (2, 1))
    assert sorted(two) == sorted(one)
    assert _relative_l2(two, one) < 1e-4
    lines, _ = _finish_run_net(_start_run_net(
        tmp_path / "mf2", 2, "TPU.SHARD_STRATEGY", "dp_sp", "SOLVER.MAX_EPOCH", "2",
        cfg="tiny_maskfeat_synthetic.yaml"), tmp_path / "mf2")
    assert any("Resumed SSL training from" in line for line in lines)
    losses = [json.loads(line.split("json_stats: ", 1)[1])["loss"] for line in lines
              if "json_stats: " in line and "train_iter" in line]
    assert losses and all(np.isfinite(losses))
    assert sorted(_checkpoint(tmp_path / "mf2", 2)) == sorted(one)
