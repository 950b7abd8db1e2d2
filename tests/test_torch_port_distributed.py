"""The port's multi-process training and testing against the JAX package's
global step, on the CPU: 2 ranks over gloo, spawned, tiny widths.

Every collective of a rank waits at most ``RANK_TIMEOUT_S`` and a spawn at
most ``JOIN_TIMEOUT_S`` (tests/torch_port_util.py), so that a hang fails the
test. One spawn runs every case (``rank_cases``) while this process computes
the references:

- (a) the ``dp`` train step of tiny UniFormer, X3D, MViT and SlowFast, 2
  ranks x 2 rows, MixUp on, the rect crop with one portrait row on rank 0 and none on
  rank 1, against the JAX package's ``make_train_step(model_pm=...)`` on the
  global batch of 4 with the same draws (RandAugment, erasing, MixUp, and
  the head dropout masks of X3D and SlowFast; SlowFast's port steps in
  float64 activations, JAX's ReLUs taking the port's decisions): loss and
  grad norm to rtol 1e-4, top-1/top-5
  equal, the updated weights and BatchNorm running statistics as each
  model's one-process parity test holds them; the gradients against the
  port's one-process step on the global batch (relative L2 1e-5); the
  whole-batch select on every rank where a forward runs collectives
  (BatchNorm in training, FSDP), each rank's own split elsewhere;
- (b) the ``fsdp`` step equal to the ``dp`` step, and a checkpoint written
  under one strategy resumed under the other (every weight and optimizer
  tensor), then a second step under each equal to the one-process port's;
- (c) precise BN over 2 ranks against
  ``pmv_tpu.engine.precise_bn.calculate_and_update_precise_bn`` on the
  global batches;
- (d) ``perform_test`` on 2 ranks with shards of unequal length: the
  TestMeter equals the one-process run's and every clip is scored once;
- (e) the global BatchNorm module, forward and backward, equal to one
  process on the concatenated rows; and SubBatchNorm's splits of the
  global batch of 6 rows (3 a rank): 2 splits, each inside a rank, and 3
  splits, the middle one spanning both ranks;
- (f) ``python -m pmv_tpu_torch.tools.run_net --cfg configs/tiny_synthetic.yaml
  --device cpu`` with NUM_GPUS 2: train, checkpoint, eval and test give the
  one-process run's ``test_final``, the checkpoint is written once, and a
  second call resumes from it;
- (g) the SSL steps under ``dp`` (a spawn of their own, ``rank_ssl_cases``):
  the MoCo, SimCLR, SwAV and BYOL steps of the tiny Slow contrastive model
  (tests/test_torch_port_contrastive_train.py), 2 ranks x 2 rows, against
  the JAX package's step on the global batch of 4 with the same colour
  draws, JAX's ReLUs taking the one-process port step's decisions: loss,
  grad norm, gradients and every tensor of the state after the step (the
  queue filled with both ranks' keys, the bank with both ranks' rows) as
  the one-process tests hold them; and the MaskFeat step with loader masks
  of unequal counts on the two ranks (57 + 56 against 7 + 6 masked
  tokens of 128 a clip), against JAX's on the global batch with its HOG bins held: the
  loss divides by the global count;
- (h) AVSlowFast (the tiny yaml of tests/test_torch_port_avslowfast.py at
  DROPPATHWAY_RATE 0.5, float64 activations, as SlowFast's) under ``dp``
  and ``fsdp``, 2 ranks x 2 rows, two steps, the first at epoch 0 and the
  second at DATA.MIX_NEG_EPOCH, each batch's misaligned audio rolled into
  its easy negatives across the ranks: every rank takes the one-process
  run's DropPathway decisions, the rolled clips, the loss and each AVS
  loss (their sums over the global batch), the grad norm, the gradients
  and the state after the steps of one process on the global batch;
- (i) AVA detection (the tiny SlowFast yaml of
  tests/test_torch_port_detection.py, float64 activations, head dropout
  0.5) under ``dp``, 2 ranks x 2 clips holding 5 and 1 valid boxes: the
  loss divides by the global count of boxes, so the step's loss, grad
  norm, gradients and state equal one process's on the global batch; then
  ``test_detection`` over the ranks' shards of a dump written from a seed
  gathers the scores, boxes and metadata into the one-process run's mAP;
- (j) MViT under ``dp_sp`` on a grid of data 1 x model 2 (the tiny MViT at
  8 frames, so that its 4 token planes split 2 and 2, with 3x3x3 pools so
  that K1 runs on each rank's planes extended by their halo), both ranks
  holding the global batch of 4 with its portrait row: the train step
  against the JAX step on the global batch at (a)'s tolerance, every rank
  on the whole-batch select; the eval scores and ``perform_test`` (each
  clip counted once) against one process;
- (k) UniFormer under ``dp_sp`` on the same grid: tiny UniFormer at 8
  frames (2 + 2 token planes after the stride-2 patch embed), DropPath on
  (rates 0 to 0.6, JAX's masks read off its DropPath modules), the rect
  crop with its portrait row: the train step against JAX's on the global
  batch at (a)'s tolerances and the one-process port's gradients
  (relative L2 1e-5: no collective's backward, the global BatchNorm's
  among them, counts a rank's share twice), the K1 extents, the eval
  scores, precise BN and ``perform_test`` against one process; with
  UNIFORMER.SPLIT (the temporal branch's keys gathered, the spatial
  branch's DropPath masks cut to the rank's frames) against one process;
- (l) the SSL steps of (g) under ``fsdp`` in the same spawn: each against
  JAX's global step at (g)'s tolerances and against ``dp``'s to float
  rounding; MoCo's checkpoint written under each strategy resumed under
  the other (every tensor as written, the optimizer's state), then a
  second step under both.
"""

import contextlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_avslowfast as av_test
import test_torch_port_contrastive_train as ssl_train
import test_torch_port_detection as det_test
import test_torch_port_maskfeat_train as mf_train
import test_torch_port_pm as mvit_pm
import test_torch_port_slowfast_train as sf_train
import test_torch_port_uniformer_train as uni_train
import test_torch_port_x3d_train as x3d_train
from pmv_tpu.engine import precise_bn as jprecise_bn
from pmv_tpu.engine import ssl_steps as jssl
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine.train_state import TrainState
from pmv_tpu.models import optimizer as joptim
from pmv_tpu.parallel import mesh as mesh_lib
from pmv_tpu_torch.engine import train as ptrain
from pmv_tpu_torch.engine.steps import init_state, make_eval_step, make_train_step
from pmv_tpu_torch.engine.test import perform_test
from pmv_tpu_torch.entry import mvitv2_s_cfg
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.models.batchnorm import BatchNorm
from pmv_tpu_torch.parallel import distributed, mesh
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.tools.grad_witness import relu_decisions
from pmv_tpu_torch.utils.device import local_device
from pmv_tpu_torch.utils import meters
from pmv_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax
from torch_port_util import (
    ClipDataset,
    finish_run_net,
    free_port,
    jax_dropout_key,
    jax_dropout_masks,
    jax_relu_decisions,
    jax_train_draws,
    join_ranks,
    numpy_tree,
    port_cfg,
    jax_drop_path_masks,
    jax_hog_bins,
    jax_ssl_step_draws,
    rank_av_steps,
    rank_cases,
    rank_detection,
    rank_ssl_cases,
    start_ranks,
    start_run_net,
)

ROOT = Path(__file__).resolve().parents[1]
PM = np.array([True, False, False, False])  # rank 0: rows 0-1, rank 1: rows 2-3
MODELS = ("uniformer", "x3d", "mvit", "slowfast")
LR = 1e-3
SP_FRAMES = 8  # (j), (k): 4 token planes, 2 a rank
SP_DROP_PATH = 0.6  # (k): UniFormer's DropPath rates 0, 0.2, 0.4 and 0.6 over its 4 blocks


def _step_case(name):
    """The case of one model handed to the ranks (its port cfg and weights,
    the global batch and the JAX step's draws for it), and what the JAX
    step needs."""
    rng = jax.random.PRNGKey(3)
    if name in ("uniformer", "uniformer_sp"):
        cfg = uni_train._train_cfg(rect=uni_train.RECT)
        if name == "uniformer_sp":
            cfg.DATA.NUM_FRAMES = SP_FRAMES
            cfg.UNIFORMER.DROP_DEPTH_RATE = SP_DROP_PATH
        batch = uni_train._batch(cfg, 0, PM)
        jmodel, jstate, tx = uni_train._jax_state(cfg, batch, 4)
        jport = jmodel
    elif name == "x3d":
        cfg = x3d_train._cfg(*x3d_train.RECT, "MIXUP.ENABLE", "True",
                             "MODEL.LOSS_FUNC", "soft_cross_entropy")
        batch = x3d_train._batch(cfg, 1, PM)
        jmodel, jstate, tx = x3d_train._jax_state(cfg, batch, 4)
        jport = jmodel
    elif name == "slowfast":
        cfg = sf_train._cfg(*sf_train.RECT, "MIXUP.ENABLE", "True",
                            "MODEL.LOSS_FUNC", "soft_cross_entropy")
        batch = sf_train._batch(cfg, 1, PM)
        jmodel, jstate, tx = sf_train._jax_state(cfg, batch, 4)
        jport = jmodel
    else:
        cfg = mvit_pm._pm_cfg()
        if name == "mvit_sp":
            cfg.DATA.NUM_FRAMES = SP_FRAMES
        batch = mvit_pm._batch(cfg, 0)
        batch["pm"] = PM
        jmodel, jport, jstate, tx = mvit_pm._jax_state(cfg, batch, 4)
    draws = jax_train_draws(cfg, rng, 0, batch["frames"].shape)
    variables = {"params": jstate.params}
    if jstate.batch_stats:
        variables["batch_stats"] = jstate.batch_stats
    jx = sf_train._pathways(cfg, batch["frames"]) if name == "slowfast" else batch["frames"]
    masks = jax_dropout_masks(jmodel, variables, jx, jax_dropout_key(rng, 0))
    if masks:  # the heads of X3D and SlowFast; the others' dropout is off
        (mask,) = masks
        draws["dropout"] = torch.tensor(mask, dtype=torch.float32)
    pcfg = port_cfg(cfg)
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    load_jax_params(model, variables)
    if name == "uniformer_sp":  # JAX's DropPath masks, which its step draws
        draws["drop_path"] = jax_drop_path_masks(jmodel, variables, jx, jax_dropout_key(rng, 0),
                                                 model)
    case = {"cfg": pcfg, "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
            "batch": batch, "draws": draws, "lr": LR}
    if name.endswith("_sp"):
        pcfg.TPU.SHARD_STRATEGY = "dp_sp"
        rect = uni_train.RECT if name == "uniformer_sp" else mvit_pm.RECT
        rng_np = np.random.default_rng(11)
        case["eval"] = {"frames": rng_np.integers(0, 256, batch["frames"].shape, np.uint8),
                        "pm": PM}
        case["test"] = {"frames": rng_np.integers(0, 256, (10, SP_FRAMES, *rect, 3), np.uint8),
                        "labels": rng_np.integers(0, cfg.MODEL.NUM_CLASSES, 5),
                        "num_clips": 2, "batch_size": 4}
    if name == "uniformer_sp":
        case["precise_batches"] = [uni_train._batch(cfg, seed, PM) for seed in (5, 6)]
    if name == "slowfast":
        # The ranks' and the one process's steps in float64 activations: in
        # float32 this net's gradients at these widths (its last stage's
        # BatchNorms normalize 4 values a channel a rank) move by the
        # rounding of the global statistics' sums.
        case["dtype"] = torch.float64
    return case, (cfg, jmodel, jport, jstate, tx, rng)


def _step_refs(case, jax_args, held=False):
    """The JAX pm train step on the global batch, and the port's
    one-process step on it with the same draws; with ``held``, JAX's ReLUs
    take the one-process step's decisions (``jax_relu_decisions``: it
    patches the modules' ReLU, so the call must have the process to
    itself)."""
    cfg, jmodel, jport, jstate, tx, rng = jax_args
    with relu_decisions() if held else contextlib.nullcontext() as decisions:
        one = _one_process_steps(case)
    jstep = jax.jit(jsteps.make_train_step(cfg, jmodel, tx, model_pm=jport))
    with jax_relu_decisions(decisions) if held else contextlib.nullcontext():
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in case["batch"].items()}, rng,
                           LR)
    return {"jax_metrics": jm, "jstate": jstate, "one": one, "cfg": cfg}


def _one_process_steps(case, second=None):
    """The port's step (and a second one) on the global batch in this
    process: (metrics, gradients, state) after each."""
    model = build_model(case["cfg"], device="cpu", dtype=case.get("dtype", torch.float32))
    model.load_state_dict(case["state_dict"])
    state = init_state(case["cfg"], model)
    step = make_train_step(case["cfg"], device="cpu")
    out = []
    for batch, draws in [(case["batch"], case["draws"])] + ([second] if second else []):
        m = step(state, batch, case["lr"], draws)
        out.append(({k: float(v) for k, v in m.items()},
                    {k: p.grad.clone() for k, p in model.named_parameters()},
                    {k: v.clone() for k, v in model.state_dict().items()}))
    return out


def _split_sp_case():
    """(k): tiny UniFormer with SplitSABlocks at ``SP_FRAMES`` frames under
    dp_sp, DropPath on: the port's seeded weights, the global batch of 4
    with its portrait row and the port's draws for it."""
    cfg = port_cfg(uni_train._train_cfg(rect=uni_train.RECT))
    cfg.DATA.NUM_FRAMES = SP_FRAMES
    cfg.UNIFORMER.SPLIT = True
    cfg.UNIFORMER.DROP_DEPTH_RATE = SP_DROP_PATH
    cfg.TPU.SHARD_STRATEGY = "dp_sp"
    batch = uni_train._batch(cfg, 2, PM)
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=7)
    draws = make_train_step(cfg, device="cpu").sample_draws(model, batch["frames"].shape)
    return {"cfg": cfg, "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
            "batch": batch, "draws": draws, "lr": LR}


def _sp_one_process_precise_bn(case):
    """Precise BN over the dp_sp case's global batches in one process: the
    running statistics after it."""
    from pmv_tpu_torch.engine.precise_bn import calculate_and_update_precise_bn

    model = build_model(case["cfg"], device="cpu", dtype=torch.float32)
    model.load_state_dict(case["state_dict"])
    calculate_and_update_precise_bn(case["precise_batches"], init_state(case["cfg"], model),
                                    case["cfg"], "cpu")
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}


def _precise_bn_case():
    """(the JAX precise BN's arguments, the case handed to the ranks)."""
    cfg = x3d_train._cfg("BN.NUM_BATCHES_PRECISE", "2")
    batches = [x3d_train._batch(cfg, seed) for seed in (5, 6)]
    jmodel, jstate, _ = x3d_train._jax_state(cfg, batches[0], 8)
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    load_jax_params(model, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    case = {"cfg": port_cfg(cfg), "state_dict": model.state_dict(), "batches": batches}
    mesh = mesh_lib.create_mesh(devices=jax.devices()[:1])
    return (batches, jstate, cfg, jmodel, mesh), case


def _test_case():
    """5 videos x 2 clips at 2 clips a rank a step: the last step's rows
    are all rank 0's."""
    cfg = mvitv2_s_cfg(tiny=True)
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (10, 2, 16, 16, 3), np.uint8)
    labels = rng.integers(0, cfg.MODEL.NUM_CLASSES, 5)
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=2)
    return {"cfg": cfg, "state_dict": model.state_dict(), "frames": frames, "labels": labels,
            "num_clips": 2, "batch_size": 2}


SUB_BN_SPLITS = (2, 3)


def _sub_bn_case():
    gen = torch.Generator().manual_seed(1)
    state_dicts = {}
    for splits in SUB_BN_SPLITS:
        bn = BatchNorm(6, num_splits=splits)
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(generator=gen)
        state_dicts[splits] = bn.state_dict()
    x = 2.0 + 3.0 * torch.randn(6, 3, 5, 6, generator=gen)
    x[2:4] += 4.0  # split means apart
    return {"x": x, "weight": torch.randn(6, 3, 5, 6, generator=gen),
            "splits": SUB_BN_SPLITS, "state_dicts": state_dicts}


def _av_case():
    """Two global batches of 4 rows (2 a rank), with audio and misaligned
    audio, and tiny AVSlowFast's weights (the port's seeded init, its
    BatchNorm scales and biases moved away from 1 and 0)."""
    cfg = port_cfg(av_test.tiny_cfg("SLOWFAST.DROPPATHWAY_RATE", "0.5"))
    model = build_model(cfg, device="cpu", dtype=torch.float64, seed=4)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, BatchNorm):
                for p in (module.weight, module.bias):
                    p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return {"cfg": cfg, "state_dict": model.state_dict(), "dtype": torch.float64, "lr": 0.05,
            "batches": [av_test._batch(seed) for seed in (7, 8)],
            "epochs": [0, cfg.DATA.MIX_NEG_EPOCH],
            "seed": 1}  # the steps' seed: DropPathway keeps the audio, then drops it


def _detection_case(case_dir):
    """A global batch of 4 clips (2 a rank) with 3 + 2 valid boxes on rank
    0 and 1 + 0 on rank 1, tiny AVA SlowFast's seeded weights, and the
    config pointed at a dump written under ``case_dir``."""
    from pmv_tpu_torch.tools.ava_dump import write_ava_dump

    root = case_dir / "ava"
    write_ava_dump(str(root), videos=2, frames=90, width=64, height=48, seed=2)
    cfg = port_cfg(det_test.tiny_cfg(
        "slowfast", "AVA.FRAME_DIR", str(root / "frames"), "AVA.FRAME_LIST_DIR",
        str(root / "frame_lists"), "AVA.ANNOTATION_DIR", str(root / "annotations"),
        "MODEL.NUM_CLASSES", "80", "TEST.BATCH_SIZE", "2"))
    halves = [det_test._batch(seed, classes=80) for seed in (3, 4)]
    batch = {k: np.concatenate([h[k] for h in halves]) for k in halves[0]}
    batch["box_mask"][1, :2] = True  # rank 0: 3 + 2 boxes; rank 1: 1 + 0
    batch["box_mask"][2, 1:] = batch["box_mask"][3] = False
    batch["labels"] *= batch["box_mask"][..., None]
    model = build_model(cfg, device="cpu", dtype=torch.float64, seed=6)
    return {"cfg": cfg, "state_dict": model.state_dict(), "dtype": torch.float64,
            "batch": batch, "lr": 0.05}


def _bn_case():
    gen = torch.Generator().manual_seed(0)
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.normal_(generator=gen)
    x = 2.0 + 3.0 * torch.randn(4, 3, 5, 6, generator=gen)
    return {"x": x, "weight": torch.randn(4, 3, 5, 6, generator=gen),
            "state_dict": bn.state_dict()}


def _sp_one_process_eval(case):
    """The dp_sp case's eval scores and ``perform_test`` in one process."""
    from pmv_tpu_torch.data.loader import DataLoader

    model = build_model(case["cfg"], device="cpu", dtype=torch.float32)
    model.load_state_dict(case["state_dict"])
    eval_step = make_eval_step(case["cfg"], model, device="cpu")
    scores = eval_step(case["eval"]["frames"], case["eval"]["pm"]).clone()
    test = case["test"]
    loader = DataLoader(ClipDataset(test["frames"], test["labels"], test["num_clips"]),
                        test["batch_size"], num_workers=1)
    meter = meters.TestMeter(len(test["labels"]), test["num_clips"],
                             case["cfg"].MODEL.NUM_CLASSES, len(loader))
    meter, stats = perform_test(loader, eval_step, meter)
    return {"scores": scores, "video_preds": meter.video_preds, "stats": stats,
            "steps": len(loader)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case through ``rank_cases`` on 2 ranks, and the references,
    computed here while the ranks run."""
    case_dir = tmp_path_factory.mktemp("two_ranks")
    with ThreadPoolExecutor(len(MODELS) + 2) as pool:  # XLA compiles in parallel
        step_futures = {name: pool.submit(_step_case, name)
                        for name in MODELS + ("mvit_sp", "uniformer_sp")}
        precise_future = pool.submit(_precise_bn_case)
        steps, jax_args = {}, {}
        for name, future in step_futures.items():
            steps[name], jax_args[name] = future.result()
        precise_args, precise = precise_future.result()
        resume = dict(steps["uniformer"])
        resume["batch2"] = uni_train._batch(jax_args["uniformer"][0], 1, PM)
        resume["draws2"] = jax_train_draws(jax_args["uniformer"][0], jax.random.PRNGKey(3), 1,
                                           resume["batch2"]["frames"].shape)
        sp, uni_sp = steps.pop("mvit_sp"), steps.pop("uniformer_sp")
        cases = {"steps": steps, "sp": sp, "uniformer_sp": uni_sp,
                 "uniformer_split_sp": _split_sp_case(), "resume": resume,
                 "precise_bn": precise, "test": _test_case(), "bn": _bn_case(),
                 "sub_bn": _sub_bn_case(), "avslowfast": _av_case(),
                 "detection": _detection_case(case_dir)}
        torch.save(cases, case_dir / "cases.pt")
        procs = start_ranks(rank_cases, str(case_dir),
                            model_size=mesh.model_size(sp["cfg"], 2))
        try:
            ref_futures = {name: pool.submit(_step_refs, steps[name], jax_args[name])
                           for name in MODELS if name != "slowfast"}
            ref_futures["mvit_sp"] = pool.submit(_step_refs, sp, jax_args["mvit_sp"])
            ref_futures["sp_eval"] = pool.submit(_sp_one_process_eval, sp)
            ref_futures["uniformer_sp"] = pool.submit(_step_refs, uni_sp,
                                                      jax_args["uniformer_sp"])
            ref_futures["uniformer_sp_eval"] = pool.submit(_sp_one_process_eval, uni_sp)
            ref_futures["uniformer_sp_precise_bn"] = pool.submit(_sp_one_process_precise_bn,
                                                                 uni_sp)
            ref_futures["uniformer_split_sp"] = pool.submit(_one_process_steps,
                                                            cases["uniformer_split_sp"])
            ref_futures["resume"] = pool.submit(
                _one_process_steps, resume, (resume["batch2"], resume["draws2"]))
            ref_futures["precise_bn"] = pool.submit(
                jprecise_bn.calculate_and_update_precise_bn, *precise_args)
            ref_futures["avslowfast"] = pool.submit(rank_av_steps, 0, 1, cases["avslowfast"])
            ref_futures["detection"] = pool.submit(rank_detection, 0, 1, cases["detection"])
            refs = {key: future.result() for key, future in ref_futures.items()}
            # SlowFast's float32 gradients move with a ReLU that decides otherwise:
            # its reference holds JAX's ReLUs, alone in the process.
            refs["slowfast"] = _step_refs(steps["slowfast"], jax_args["slowfast"], held=True)
        finally:
            join_ranks(procs)
    return torch.load(case_dir / "results.pt", weights_only=False), refs, cases


def _relative_l2(got, want):
    diff = sum(float((got[k] - v).square().sum()) for k, v in want.items())
    return (diff / sum(float(v.square().sum()) for v in want.values())) ** 0.5


@pytest.mark.parametrize("name", MODELS)
def test_dp_step_matches_jax_on_the_global_batch(two_ranks, name):
    results, refs, _ = two_ranks
    got, ref = results[name, "dp"], refs[name]
    jm = ref["jax_metrics"]
    np.testing.assert_allclose(got["metrics"]["loss"], float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], float(jm["grad_norm"]), rtol=1e-4)
    for key in ("top1_err", "top5_err"):
        np.testing.assert_allclose(got["metrics"][key], float(jm[key]), rtol=1e-6)
    assert not got["metrics"]["nan"]
    _, one_grads, _ = ref["one"][0]
    assert _relative_l2(got["grads"], one_grads) < 1e-5
    model = build_model(port_cfg(ref["cfg"]), device="cpu", dtype=torch.float32)
    model.load_state_dict(got["state"])
    if name == "uniformer":
        uni_train._assert_state_matches(model, ref["jstate"], [LR])
    elif name == "x3d":
        x3d_train._assert_state_matches(model, ref["jstate"])
    elif name == "slowfast":
        before = {k: v.clone() for k, v in two_ranks[2]["steps"][name]["state_dict"].items()}
        sf_train._assert_state_matches(model, ref["jstate"], before)
    else:
        want = state_dict_from_jax(numpy_tree(ref["jstate"].params))
        for key, value in want.items():
            if not key.endswith("norm_k.bias"):  # float noise that Adam scales to +-lr
                np.testing.assert_allclose(got["state"][key].numpy(), value.numpy(),
                                           atol=1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", MODELS)
def test_fsdp_step_equals_dp(two_ranks, name):
    results, _, _ = two_ranks
    dp, fsdp = results[name, "dp"], results[name, "fsdp"]
    for key, value in dp["metrics"].items():
        np.testing.assert_allclose(fsdp["metrics"][key], value, rtol=1e-6, err_msg=key)
    assert _relative_l2(fsdp["grads"], dp["grads"]) < 1e-6
    for key, value in dp["state"].items():
        if key.endswith("norm_k.bias"):
            # MViT's key-norm bias: a shift of every key, which the softmax
            # ignores, so its gradient is float noise, which AdamW scales to
            # +-lr; dp splits the rows by orientation and fsdp takes the
            # select, so the noise differs.
            assert float((fsdp["state"][key] - value).abs().max()) <= 2.0001 * LR, key
            continue
        torch.testing.assert_close(fsdp["state"][key], value, atol=1e-6, rtol=1e-5, msg=key)


@pytest.mark.parametrize("name", MODELS)
def test_every_rank_takes_the_select_only_where_a_forward_runs_collectives(two_ranks, name):
    """Rank 0 holds a portrait row, rank 1 none. BatchNorm's training
    statistics (UniFormer, X3D) and FSDP's gathers need the same forwards on
    every rank: both ranks take the whole-batch select. MViT under dp runs
    no collective in its forward: each rank splits its own rows."""
    results, _, _ = two_ranks
    for strategy in ("dp", "fsdp"):
        split = name == "mvit" and strategy == "dp"
        want = "forward_by_orientation" if split else "select_by_orientation"
        assert results[name, strategy]["routes"] == [want, want], strategy


def test_dp_sp_step_matches_jax_on_the_global_batch(two_ranks):
    """(j): each rank of the data 1 x model 2 grid holds the global batch's
    4 rows and half of its token planes; its step is JAX's on the global
    batch, as (a) holds MViT's dp step."""
    results, refs, _ = two_ranks
    ref = refs["mvit_sp"]
    jm = ref["jax_metrics"]
    _, one_grads, _ = ref["one"][0]
    want = state_dict_from_jax(numpy_tree(ref["jstate"].params))
    for rank, got in enumerate(results["sp"]):
        assert got["layout"] == mesh.Layout(0, 1, rank, 2)
        np.testing.assert_allclose(got["metrics"]["loss"], float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-4)
        for key in ("top1_err", "top5_err"):
            np.testing.assert_allclose(got["metrics"][key], float(jm[key]), rtol=1e-6)
        assert not got["metrics"]["nan"]
        assert _relative_l2(got["grads"], one_grads) < 1e-5
        for key, value in want.items():
            if not key.endswith("norm_k.bias"):  # float noise that Adam scales to +-lr
                np.testing.assert_allclose(got["state"][key].numpy(), value.numpy(),
                                           atol=1e-5, rtol=0, err_msg=key)


def test_dp_sp_takes_the_select_and_k1_on_halo_extended_slices(two_ranks):
    """Every forward under dp_sp runs collectives: every rank takes the
    whole-batch select. The tiny MViT's three stride-1 3x3x3 pools a
    forward (block 0's q, block 1's K and V) run K1 on 2 + 2 halo planes,
    forward and dx, and the weight gradient on the same extent: in the
    train step, two forwards (both orientations); in the eval step, two."""
    results, _, _ = two_ranks
    for got in results["sp"]:
        assert got["routes"] == ["select_by_orientation"] * 2
        kinds = [kind for kind, _ in got["shapes"]]
        assert [kinds.count(k) for k in ("fwd", "dx", "wgrad")] == [6, 6, 6]
        assert [kind for kind, _ in got["eval_shapes"]] == ["fwd"] * 6
        for _, shape in got["shapes"] + got["eval_shapes"]:
            assert shape[1] == SP_FRAMES // 2 // 2 + 2, shape


def test_dp_sp_eval_and_perform_test_equal_one_process(two_ranks):
    """The eval scores of each rank (with a portrait row) and the gathered
    TestMeter (model rank 0's clips only: each clip counted once) equal one
    process's."""
    results, refs, _ = two_ranks
    one = refs["sp_eval"]
    for got in results["sp"]:
        torch.testing.assert_close(got["scores"], one["scores"], atol=1e-6, rtol=1e-5)
        test = got["test"]
        assert test["steps"] == one["steps"] == 3
        np.testing.assert_array_equal(test["clip_count"], [2] * 5)
        np.testing.assert_allclose(test["video_preds"], one["video_preds"], atol=1e-6,
                                   rtol=1e-5)
        assert test["stats"] == one["stats"]


def test_uniformer_dp_sp_step_matches_jax_on_the_global_batch(two_ranks):
    """(k): tiny UniFormer at 8 frames on the data 1 x model 2 grid, each
    rank half of its token planes after the stride-2 patch embed (2 and 2),
    DropPath on with JAX's masks, the rect crop with one portrait row: the
    step is JAX's on the global batch (loss and grad norm to rtol 1e-4,
    the weights and BatchNorm statistics as the one-process UniFormer test
    holds them) and its gradients the port's one-process step's (relative
    L2 1e-5): no collective's backward counts a rank's share twice, the
    global BatchNorm's among them."""
    results, refs, cases = two_ranks
    ref = refs["uniformer_sp"]
    jm = ref["jax_metrics"]
    _, one_grads, _ = ref["one"][0]
    drop_path = cases["uniformer_sp"]["draws"]["drop_path"]
    assert drop_path[0] is None and any(float(m.min()) == 0.0 for block in drop_path[1:]
                                        for m in block)  # some rows dropped
    model = build_model(port_cfg(ref["cfg"]), device="cpu", dtype=torch.float32)
    for rank, got in enumerate(results["uniformer_sp"]):
        assert got["layout"] == mesh.Layout(0, 1, rank, 2)
        np.testing.assert_allclose(got["metrics"]["loss"], float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-4)
        for key in ("top1_err", "top5_err"):
            np.testing.assert_allclose(got["metrics"][key], float(jm[key]), rtol=1e-6)
        assert not got["metrics"]["nan"]
        assert _relative_l2(got["grads"], one_grads) < 1e-5
        model.load_state_dict(got["state"])
        uni_train._assert_state_matches(model, ref["jstate"], [LR])
    first, second = results["uniformer_sp"]
    for key, value in first["state"].items():  # every rank's statistics the same
        assert torch.equal(second["state"][key], value), key


def test_uniformer_dp_sp_takes_the_select_and_k1_on_halo_extended_slices(two_ranks):
    """Every rank takes the whole-batch select; the 4 DPE convs a forward
    run K1 on 2 + 2 halo planes, forward and dx, and the weight gradient on
    the same extent: two forwards a train step (both orientations), two an
    eval."""
    results, _, _ = two_ranks
    for got in results["uniformer_sp"]:
        assert got["routes"] == ["select_by_orientation"] * 2
        kinds = [kind for kind, _ in got["shapes"]]
        assert [kinds.count(k) for k in ("fwd", "dx", "wgrad")] == [8, 8, 8]
        assert [kind for kind, _ in got["eval_shapes"]] == ["fwd"] * 8
        for _, shape in got["shapes"] + got["eval_shapes"]:
            assert shape[1] == SP_FRAMES // 2 // 2 + 2, shape


def test_uniformer_dp_sp_eval_precise_bn_and_perform_test_equal_one_process(two_ranks):
    """Each rank's eval scores (a portrait row), its precise BN statistics
    and the gathered TestMeter (model rank 0's clips) equal one
    process's."""
    results, refs, _ = two_ranks
    one = refs["uniformer_sp_eval"]
    for got in results["uniformer_sp"]:
        torch.testing.assert_close(got["scores"], one["scores"], atol=1e-6, rtol=1e-5)
        test = got["test"]
        assert test["steps"] == one["steps"] == 3
        np.testing.assert_array_equal(test["clip_count"], [2] * 5)
        np.testing.assert_allclose(test["video_preds"], one["video_preds"], atol=1e-6,
                                   rtol=1e-5)
        assert test["stats"] == one["stats"]
        want = refs["uniformer_sp_precise_bn"]
        assert sorted(got["precise_bn"]) == sorted(want)
        for key, value in want.items():
            torch.testing.assert_close(got["precise_bn"][key], value, atol=1e-6, rtol=1e-5,
                                       msg=key)


def test_uniformer_split_dp_sp_step_equals_one_process(two_ranks):
    """UNIFORMER.SPLIT: the temporal branch's keys gathered over T, this
    rank's queries; the spatial branch's per-(clip, frame) DropPath masks
    cut to this rank's planes: the step equals one process's on the global
    batch."""
    results, refs, cases = two_ranks
    (one_metrics, one_grads, one_state), = refs["uniformer_split_sp"]
    masks = cases["uniformer_split_sp"]["draws"]["drop_path"]
    t_mask = masks[2][1].reshape(len(PM), -1)  # stage 3's spatial branch: a mask a frame
    assert t_mask.shape[1] == SP_FRAMES // 2 and (t_mask == 0).any()
    for got in results["uniformer_split_sp"]:
        for key in ("loss", "grad_norm", "top1_err", "top5_err"):
            np.testing.assert_allclose(got["metrics"][key], one_metrics[key], rtol=1e-5,
                                       err_msg=key)
        assert _relative_l2(got["grads"], one_grads) < 1e-5
        _assert_weights_close(got["state"], one_state, [LR])


def _assert_weights_close(got, want, lrs, stats_tol=(1e-6, 1e-5)):
    """Tiny UniFormer's state: BatchNorm buffers to ``stats_tol`` (atol,
    rtol);
    weights as tests/test_torch_port_uniformer_train.py holds them: to 1e-5,
    but the few whose gradient is float noise, which AdamW's first steps
    (about lr x sign(g)) may move either way: within 2 x the summed LRs, and
    no more than 1e-3 of the elements; the weights whose whole gradient is
    float noise (the last block's fc2 bias, the keys' qkv bias) are left
    out."""
    n_off = n = 0
    for key, value in want.items():
        if "running" in key or key.endswith("num_batches_tracked"):
            torch.testing.assert_close(got[key], value.to(got[key].dtype), atol=stats_tol[0],
                                       rtol=stats_tol[1], msg=key)
            continue
        a, b = got[key], value
        if key == "blocks4.0.mlp.fc2.bias":
            continue
        if key.endswith("qkv.bias"):
            c = len(a) // 3
            a, b = torch.cat([a[:c], a[2 * c:]]), torch.cat([b[:c], b[2 * c:]])
        diff = (a - b).abs()
        assert float(diff.max()) <= 2.0001 * sum(lrs), key
        n_off += int((diff > 1e-5).sum())
        n += diff.numel()
    assert n_off <= 1e-3 * n, f"{n_off} of {n} weights off by more than 1e-5"


def test_checkpoint_resumes_across_strategies(two_ranks):
    """A dp checkpoint resumed under fsdp and an fsdp one under dp hold the
    same weights and optimizer state; the second step under each equals the
    one-process port's second step; each file was written once."""
    results, refs, _ = two_ranks
    res = results["resume"]
    (dp_model, dp_opt), (fsdp_model, fsdp_opt) = res["first"]["dp"], res["first"]["fsdp"]
    for key, value in dp_model.items():
        torch.testing.assert_close(fsdp_model[key], value, atol=1e-6, rtol=1e-5, msg=key)
    assert dp_opt["param_groups"] == fsdp_opt["param_groups"]
    for i, state in dp_opt["state"].items():
        for key, value in state.items():
            torch.testing.assert_close(fsdp_opt["state"][i][key], value, atol=1e-6, rtol=1e-5)
    _assert_weights_close(dp_model, refs["resume"][0][2], [LR])
    for strategy in ("dp", "fsdp"):
        # The second step's batch statistics see weights that the first
        # moved by the noise above: the running statistics as the
        # two-step UniFormer test holds them (atol 2e-4, rtol 1e-4).
        _assert_weights_close(res["second"][strategy], refs["resume"][1][2], [LR, LR],
                              stats_tol=(2e-4, 1e-4))
    assert res["files"] == ["checkpoint_epoch_00001.pyth"]


@pytest.mark.parametrize("strategy", ["dp", "fsdp"])
def test_avslowfast_step_over_two_ranks_equals_one_process(two_ranks, strategy):
    """The DropPathway decisions, the easy negatives rolled across ranks,
    the AVS losses over the global batch, the loss, the grad norm, the
    gradients and the state of two steps equal one process's on the global
    batch (float64 activations)."""
    results, refs, cases = two_ranks
    got, one = results["avslowfast", strategy], refs["avslowfast"]
    firsts = [batch["audio_mis"][:, 0, 0].tolist() for batch in cases["avslowfast"]["batches"]]
    # Epoch 0: each row takes the next row's clip (rank 1's last takes rank
    # 0's first); at MIX_NEG_EPOCH the first 3 of 4 rows cycle, the last
    # keeps its own.
    assert [step["rolled"][:, 0, 0].tolist() for step in one["steps"]] == [
        [firsts[0][i] for i in (1, 2, 3, 0)], [firsts[1][i] for i in (1, 2, 0, 3)]]
    # The seed's decisions: the audio kept in the first step, dropped in
    # the second; every rank's the same.
    assert [ref["decisions"] for ref in one["steps"]] == [[False], [True]]
    for mine, ref in zip(got["steps"], one["steps"]):
        np.testing.assert_array_equal(mine["rolled"], ref["rolled"])
        assert mine["decisions"] == ref["decisions"] * 2
        assert sorted(k for k in mine["metrics"] if k.endswith("_avs")) == [
            "s3_avs", "s4_avs", "s5_avs"]
        for key, value in ref["metrics"].items():
            np.testing.assert_allclose(mine["metrics"][key], value, rtol=1e-6, atol=1e-9,
                                       err_msg=key)
    assert _relative_l2(got["grads"], one["grads"]) < 1e-5
    # Two SGD steps' updates (the gradients they hold) to relative L2 1e-5;
    # the BatchNorm statistics.
    before = cases["avslowfast"]["state_dict"]
    names = [k for k in before if "running" not in k and not k.endswith("num_batches_tracked")]
    assert _relative_l2({k: before[k] - got["state"][k] for k in names},
                        {k: before[k] - one["state"][k] for k in names}) < 1e-5
    for key in set(before) - set(names):
        torch.testing.assert_close(got["state"][key], one["state"][key], atol=1e-7, rtol=1e-6,
                                   msg=key)


def test_detection_step_and_test_over_two_ranks_equal_one_process(two_ranks):
    """Unequal box counts on the ranks (5 and 1): the loss, the grad norm,
    the gradients and the state equal one process's on the global batch;
    the gathered test's AVA mAP equals one process's."""
    results, refs, cases = two_ranks
    got, one = results["detection"], refs["detection"]
    mask = cases["detection"]["batch"]["box_mask"]
    assert mask[:2].sum() == 5 and mask[2:].sum() == 1
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][key], one["metrics"][key], rtol=1e-6,
                                   err_msg=key)
    assert got["metrics"]["nan"] == 0.0
    assert _relative_l2(got["grads"], one["grads"]) < 1e-5
    before = cases["detection"]["state_dict"]
    names = [k for k in before if "running" not in k and not k.endswith("num_batches_tracked")]
    assert _relative_l2({k: before[k] - got["state"][k] for k in names},
                        {k: before[k] - one["state"][k] for k in names}) < 1e-5
    for key in set(before) - set(names):
        torch.testing.assert_close(got["state"][key], one["state"][key], atol=1e-7, rtol=1e-6,
                                   msg=key)
    assert 0.0 < one["map"] <= 1.0
    np.testing.assert_allclose(got["map"], one["map"], atol=1e-6, rtol=0)


def test_precise_bn_matches_jax_over_two_ranks(two_ranks):
    results, refs, cases = two_ranks
    got = results["precise_bn"]
    want = state_dict_from_jax(numpy_tree({"params": {}, "batch_stats":
                                           refs["precise_bn"].batch_stats}))
    before = cases["precise_bn"]["state_dict"]
    for name, value in want.items():
        if name.endswith("num_batches_tracked"):
            assert torch.equal(got[name], before[name]), name
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
        assert not torch.equal(got[name], before[name]), name


def test_perform_test_gathers_every_clip_once(two_ranks):
    """Rank 1's shard ends a step early; the gathered TestMeter equals the
    one-process run's over the same clips, each clip counted once."""
    results, _, cases = two_ranks
    case, got = cases["test"], results["test"]
    model = build_model(case["cfg"], device="cpu", dtype=torch.float32)
    model.load_state_dict(case["state_dict"])
    from pmv_tpu_torch.data.loader import DataLoader

    loader = DataLoader(ClipDataset(case["frames"], case["labels"], 2), 4, num_workers=1)
    meter = meters.TestMeter(5, 2, case["cfg"].MODEL.NUM_CLASSES, len(loader))
    meter, stats = perform_test(loader, make_eval_step(case["cfg"], model, device="cpu"), meter)
    assert got["steps"] == len(loader) == 3 and list(got["local_batches"]) == [3, 2]
    np.testing.assert_array_equal(got["clip_count"], [2] * 5)
    np.testing.assert_allclose(got["video_preds"], meter.video_preds, atol=1e-6, rtol=1e-5)
    assert got["stats"] == stats


def test_global_batchnorm_equals_one_process(two_ranks):
    results, _, cases = two_ranks
    case, got = cases["bn"], results["bn"]
    bn = BatchNorm(6)
    bn.load_state_dict(case["state_dict"])
    x = case["x"].clone().requires_grad_()
    y = bn.train()(x)
    (y * case["weight"]).sum().backward()
    np.testing.assert_allclose(got["y"], y.detach().numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["x_grad"], x.grad.numpy(), atol=1e-5, rtol=1e-5)
    for g, want in zip(got["param_grads"], (bn.weight.grad, bn.bias.grad)):
        torch.testing.assert_close(g, want, atol=1e-5, rtol=1e-5)
    for key, value in bn.state_dict().items():
        torch.testing.assert_close(got["state"][key], value, atol=1e-6, rtol=1e-5, msg=key)


@pytest.mark.parametrize("splits", SUB_BN_SPLITS)
def test_sub_batchnorm_splits_of_the_global_batch_equal_one_process(two_ranks, splits):
    """A split is a slice of the global batch, inside a rank (2 splits) or
    across ranks (3): forward, backward and the split statistics equal one
    process's on the concatenated rows."""
    results, _, cases = two_ranks
    case, got = cases["sub_bn"], results["sub_bn"][splits]
    bn = BatchNorm(6, num_splits=splits)
    bn.load_state_dict(case["state_dicts"][splits])
    x = case["x"].clone().requires_grad_()
    y = bn.train()(x)
    (y * case["weight"]).sum().backward()
    np.testing.assert_allclose(got["y"], y.detach().numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["x_grad"], x.grad.numpy(), atol=1e-5, rtol=1e-5)
    for g, want in zip(got["param_grads"], (bn.weight.grad, bn.bias.grad)):
        torch.testing.assert_close(g, want, atol=1e-5, rtol=1e-5)
    for key, value in bn.state_dict().items():
        torch.testing.assert_close(got["state"][key], value, atol=1e-6, rtol=1e-5, msg=key)
    assert got["state"]["running_mean"].shape == (splits * 6,)


def _argv(out, nproc, *opts):
    return ["--cfg", str(ROOT / "configs" / "tiny_synthetic.yaml"), "--device", "cpu",
            "--init_method", f"tcp://127.0.0.1:{free_port()}", "--opts", "OUTPUT_DIR", str(out),
            "NUM_GPUS", str(nproc), "DATA_LOADER.NUM_WORKERS", "2", *opts]


def _run_net_two_processes(out, *opts):
    """run_net with NUM_GPUS 2 (``start_run_net``: one thread a process;
    with the ranks' intra-op threads claiming the host's cores beside other
    test workers, the call once ran past JOIN_TIMEOUT_S, ROADMAP.md, section
    3), killed with every rank it spawned after JOIN_TIMEOUT_S."""
    finish_run_net(start_run_net(_argv(out, 2, *opts)))


def _json_stats(path):
    lines = Path(path).read_text().splitlines()
    return [json.loads(line.split("json_stats: ", 1)[1]) for line in lines
            if "json_stats: " in line]


def test_run_net_two_processes_equal_one_and_resume(tmp_path):
    """NUM_GPUS 2: 4 clips a process a step, the one-process run's 8; the
    same test_final; one checkpoint, written by rank 0; a resume. (The
    TensorBoard writer is left off: its import pulls in TensorFlow where that
    is installed, seconds of a rank's time; tests/test_torch_port_tensorboard.py
    holds it to rank 0.)"""
    two, one = tmp_path / "two", tmp_path / "one"
    _run_net_two_processes(two)
    assert run_net.main(_argv(one, 1)) == 0
    final = [s for s in _json_stats(two / "stdout.log") if s.get("split") == "test_final"]
    want = [s for s in _json_stats(one / "stdout.log") if s.get("split") == "test_final"]
    assert final == want and len(final) == 1
    log = (two / "stdout.log").read_text()
    assert log.count("Saved checkpoint") == 1
    assert os.listdir(two / "checkpoints") == ["checkpoint_epoch_00001.pyth"]
    a = torch.load(two / "checkpoints" / "checkpoint_epoch_00001.pyth", weights_only=True)
    b = torch.load(one / "checkpoints" / "checkpoint_epoch_00001.pyth", weights_only=True)
    assert a["optimizer_state"]["param_groups"][0]["count"] == 8  # 64 videos, 8 a step

    _run_net_two_processes(two, "SOLVER.MAX_EPOCH", "2")
    log = (two / "stdout.log").read_text()
    assert "Load from last checkpoint" in log and "Start epoch: 2" in log
    assert sorted(os.listdir(two / "checkpoints")) == [
        "checkpoint_epoch_00001.pyth", "checkpoint_epoch_00002.pyth"]
    assert _json_stats(two / "stdout.log")[-1]["split"] == "test_final"
    assert b["epoch"] == a["epoch"] == 0


def test_a_process_never_shares_a_card():
    with pytest.raises(RuntimeError):
        local_device(torch.cuda.device_count(), "cuda")
    assert local_device(3, "cpu") == torch.device("cpu")


def test_train_refuses_a_world_it_is_not_launched_in(tmp_path):
    cfg = port_cfg(x3d_train._cfg())
    cfg.NUM_GPUS = 2
    cfg.OUTPUT_DIR = str(tmp_path)
    with pytest.raises(RuntimeError, match="launch_job"):
        ptrain.train(cfg, device="cpu")


# ------------------------------------------------------------ (g) SSL under dp

SSL_TYPES = ("moco", "simclr", "swav", "byol")
MASK_P = np.array([0.45, 0.4, 0.05, 0.08])  # rows 0-1 on rank 0, 2-3 on rank 1


def _contrastive_case(ssl_type):
    """(the case handed to the ranks, the JAX reference of the global
    step): the port's one-process step on the global batch records its
    ReLU decisions, which JAX's ReLUs take."""
    cfg = ssl_train.step_cfg(ssl_type)
    jmodel, jstate, tx = ssl_train.jax_ssl_state(cfg)
    frames = ssl_train._frames(0)
    rng = jax.random.PRNGKey(3)
    draws = jax_ssl_step_draws(cfg, rng, 0, frames.shape)
    pcfg = port_cfg(cfg)
    state_dict = ssl_train.port_state_dict(jstate, ssl_type)
    case = {"cfg": pcfg, "state_dict": state_dict, "batch": {
        "frames": frames, "index": ssl_train.INDEX}, "draws": draws, "lr": ssl_train.LR}
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(state_dict)
    from pmv_tpu_torch.engine import ssl_steps

    with relu_decisions() as decisions:
        ssl_steps.make_ssl_train_step(pcfg, device="cpu")(
            ssl_steps.init_ssl_state(pcfg, model), case["batch"], ssl_train.LR, draws)
    masks = [m.numpy() for m in ssl_train.jax_order(decisions, ssl_type).masks]
    jframes = np.repeat(frames[:, None], ssl_train.VIEWS, axis=1)  # views 0, 1: the clip

    def reference():
        jnew, jm = ssl_train.jax_step(ssl_type, cfg, jmodel, tx)(
            jstate, {"frames": jnp.asarray(jframes), "index": jnp.asarray(ssl_train.INDEX)},
            rng, ssl_train.LR, masks)
        trace = ssl_train._trace(jnew.opt_state)
        grads = state_dict_from_jax(numpy_tree({
            "params": trace["online"], "predictor_params": trace.get("predictor"),
            "prototypes": trace.get("prototypes")}))
        return {"metrics": jm, "grads": grads,
                "state": ssl_train.port_state_dict(jnew, ssl_type)}

    return case, reference


def _maskfeat_case():
    """The masked step with the loader's masks: the ranks' counts differ."""
    cfg = mf_train._step_cfg()
    batch = mf_train._batch(4, 32, 0)
    batch["mask"] = np.random.default_rng(1).uniform(size=(4, 128)) < MASK_P[:, None]
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
    b1 = cfg.SOLVER.BETAS[0]
    clip = min(1.0, cfg.SOLVER.CLIP_GRAD_L2NORM / float(jm["grad_norm"]))
    grads = state_dict_from_jax(jax.tree_util.tree_map(
        lambda mu: np.asarray(mu, np.float64) / ((1 - b1) * clip),
        mf_train._adam_first_moment(jnew)))
    case = {"cfg": port_cfg(cfg), "state_dict": state_dict_from_jax(numpy_tree(params)),
            "batch": batch, "draws": {"hog_bins": torch.tensor(jax_hog_bins(x))},
            "lr": mf_train.LR}
    ref = {"metrics": jm, "grads": grads, "state": state_dict_from_jax(numpy_tree(jnew.params))}
    return case, lambda: ref


@pytest.fixture(scope="module")
def ssl_two_ranks(tmp_path_factory):
    """The SSL cases on 2 ranks (``rank_ssl_cases``), and the JAX package's
    global steps, computed here while the ranks run (the contrastive ones
    patch flax's ReLU while they trace: one at a time)."""
    case_dir = tmp_path_factory.mktemp("ssl_two_ranks")
    cases, references = {}, {}
    for name in SSL_TYPES:
        cases[name], references[name] = _contrastive_case(name)
    cases["maskfeat"], references["maskfeat"] = _maskfeat_case()
    resume = dict(cases["moco"])
    resume["batch2"] = {"frames": np.random.default_rng(12).integers(
        0, 256, resume["batch"]["frames"].shape, np.uint8), "index": ssl_train.INDEX[::-1].copy()}
    cases["ssl_resume"] = resume
    torch.save(cases, case_dir / "ssl_cases.pt")
    procs = start_ranks(rank_ssl_cases, str(case_dir))
    try:
        refs = {name: reference() for name, reference in references.items()}
    finally:
        join_ranks(procs)
    return torch.load(case_dir / "ssl_results.pt", weights_only=False), refs, cases


@pytest.mark.parametrize("name", SSL_TYPES + ("maskfeat",))
def test_ssl_dp_step_matches_jax_on_the_global_batch(ssl_two_ranks, name):
    _assert_ssl_step_matches_jax(ssl_two_ranks, name, "dp")


@pytest.mark.parametrize("name", SSL_TYPES + ("maskfeat",))
def test_ssl_fsdp_step_matches_jax_and_dp(ssl_two_ranks, name):
    """(l): under fsdp the online encoder and the momentum one are sharded
    alike (the EMA a local update), SwAV's prototypes stay whole: the step
    is JAX's on the global batch at (g)'s tolerances, and dp's to float
    rounding."""
    _assert_ssl_step_matches_jax(ssl_two_ranks, name, "fsdp")
    results, _, _ = ssl_two_ranks
    dp, fsdp = results[name, "dp"], results[name, "fsdp"]
    for key, value in dp["metrics"].items():
        np.testing.assert_allclose(fsdp["metrics"][key], value, rtol=1e-6, err_msg=key)
    assert _relative_l2(fsdp["grads"], dp["grads"]) < 1e-6
    for key, value in dp["state"].items():
        torch.testing.assert_close(fsdp["state"][key], value, atol=1e-5, rtol=1e-5, msg=key)


def test_ssl_checkpoint_resumes_across_strategies(ssl_two_ranks):
    """MoCo's checkpoint, written once under one strategy (the momentum
    encoder gathered whole under fsdp, the queue, its pointer, the bank),
    resumes under the other with every tensor and the optimizer's state as
    written; a second step then gives the same state under both."""
    results, _, _ = ssl_two_ranks
    res = results["ssl_resume"]
    written = res["written"]
    assert {"queue", "queue_ptr", "bank"} <= set(written["dp"])
    assert any(k.startswith("momentum.backbone.") for k in written["dp"])
    for strategy, other in (("dp", "fsdp"), ("fsdp", "dp")):
        assert res["files"][strategy] == ["ssl_checkpoint_epoch_00001.pyth"]
        model_state, _ = res["first"][strategy]  # written under strategy, resumed under other
        assert set(model_state) == set(written[strategy])
        for key, value in written[strategy].items():
            assert torch.equal(model_state[key], value), (strategy, key)
        torch.testing.assert_close(written[strategy], written[other], atol=1e-5, rtol=1e-5)
    (_, dp_opt), (_, fsdp_opt) = res["first"]["dp"], res["first"]["fsdp"]
    assert dp_opt["param_groups"] == fsdp_opt["param_groups"]
    # SGD's momentum: the first step's gradients, dp's and fsdp's (float
    # rounding apart, as test_ssl_fsdp_step_matches_jax_and_dp holds them).
    assert dp_opt["state"].keys() == fsdp_opt["state"].keys()
    flat = {(i, k): v for i, st in dp_opt["state"].items() for k, v in st.items()}
    assert _relative_l2({(i, k): fsdp_opt["state"][i][k] for i, k in flat}, flat) < 1e-6
    torch.testing.assert_close(res["second"]["fsdp"], res["second"]["dp"], atol=1e-5,
                               rtol=1e-5)


def _assert_ssl_step_matches_jax(ssl_two_ranks, name, strategy):
    results, refs, cases = ssl_two_ranks
    got, ref = results[name, strategy], refs[name]
    assert not got["metrics"]["nan"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][key], float(ref["metrics"][key]),
                                   atol=2e-4, rtol=1e-4, err_msg=key)
    assert set(got["grads"]) == set(ref["grads"])
    assert _relative_l2(got["grads"], {k: v.float() for k, v in ref["grads"].items()}) < 1e-4
    before = cases[name]["state_dict"]
    if name == "maskfeat":
        counts = cases[name]["batch"]["mask"].sum(axis=1)
        assert counts[:2].sum() > 2 * counts[2:].sum()  # the ranks' counts differ
    for key, value in ref["state"].items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got["state"][key].numpy(), value.numpy(), atol=2e-4,
                                   rtol=1e-4, err_msg=key)
        assert torch.equal(got["state"][key], before[key]) == torch.equal(value, before[key]), key
