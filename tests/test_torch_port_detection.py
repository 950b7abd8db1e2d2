"""The port's AVA detection (DETECTION.ENABLE) against the JAX package's.

On configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml and SLOW_8x8_R50_SHORT.yaml
cut by ``--opts``-style overrides (not edited): depth 18, width 8, 8
frames of 32^2 (SlowFast's slow pathway at 2), ROI_XFORM_RESOLUTION 4, 6
classes; res5 at stride 1 and dilation 2 as the yamls have it, so the map
is 2 x 2 at SPATIAL_SCALE_FACTOR 16. The JAX variables drawn with numpy
from a seed on the tree of ``jax.eval_shape`` of the model's init with
boxes, carried over with ``state_dict_from_jax`` and loaded strictly. A
batch of 2 clips with 16 box slots: 3 valid boxes in the first clip (one
clamped at the crop's edge), 1 in the second.

- The eval forward (sigmoid scores [B, 16, 6], 0 on padded boxes) of both
  yamls, float32, atol 1e-4.
- One detection train step of each yaml against the jitted JAX
  ``make_detection_train_step`` (per-box BCE over the valid boxes, SGD with
  Nesterov momentum and weight decay) in float64 activations on both
  sides (``jax.enable_x64``; a float32 ReLU input within a rounding of 0
  moves SlowFast's gradients, tests/test_torch_port_slowfast_train.py):
  loss and grad norm to rtol 1e-4, the SGD update (the gradient it holds)
  to relative L2 1e-4, the BatchNorm statistics; head dropout at 0, with
  one test of the head's dropout applied at the mask the JAX head draws.
- The AVA colour augmentation of the train preprocessing (ColorJitter at
  hue 0, then the PCA lighting jitter, `pmv_tpu/engine/steps.py:63-87`) at
  the draws the JAX package's key gives, against its ``make_preprocess_fn``.
- The full-size yamls' state_dicts against the JAX ``eval_shape`` trees:
  names, shapes, 33,828,888 parameters (SlowFast 32x2) and 31,798,416
  (Slow 8x8), each taking a JAX tree with ``strict=True``.
- ``run_net --device cpu`` on both yamls over a dump written from a seed
  (``tools/ava_dump.py``): one epoch trains, evaluates (the val epoch's
  AVA mAP) and tests (``test_final``'s mAP), then a second call resumes.
  SlowFast's run starts, as the recipe does, from a Kinetics SlowFast of 7
  classes written as a Caffe2 pickle (TRAIN.CHECKPOINT_TYPE caffe2): the
  trunk loads, the 7-class projection keeps its init.
"""

import json
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine.train_state import TrainState
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models import optimizer as joptim
from pmv_tpu.models.heads import ResNetRoIHead as JaxRoIHead
from pmv_tpu_torch.config.defaults import assert_and_infer_cfg
from pmv_tpu_torch.config.parser import load_config, parse_args
from pmv_tpu_torch.data.color_jitter import AVAColorDraws
from pmv_tpu_torch.engine import steps as psteps
from pmv_tpu_torch.engine.steps import init_state, make_train_step
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.models.build import MODEL_REGISTRY
from pmv_tpu_torch.models.heads import ResNetRoIHead
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.tools.ava_dump import write_ava_dump
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax
from test_torch_port_avslowfast import _jax_names_and_shapes
from test_torch_port_c2_import import _c2_name
from torch_port_util import (  # noqa: F401
    draw_variables,
    jax_color_jitter_draws,
    jax_dropout_masks,
    numpy_tree,
    one_thread,
    port_cfg,
    to_np,
)

ROOT = Path(__file__).resolve().parents[1]
YAMLS = {"slowfast": ROOT / "configs" / "AVA" / "SLOWFAST_32x2_R50_SHORT.yaml",
         "slow": ROOT / "configs" / "AVA" / "SLOW_8x8_R50_SHORT.yaml"}
BLOCK_TEMP = {"slowfast": "[[2, 2], [2, 2], [2, 2], [2, 2]]", "slow": "[[2], [2], [2], [2]]"}
TINY = ("RESNET.DEPTH", "18", "RESNET.WIDTH_PER_GROUP", "8", "DATA.NUM_FRAMES", "8",
        "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "DETECTION.ROI_XFORM_RESOLUTION", "4", "MODEL.NUM_CLASSES", "6",
        "TRAIN.MIXED_PRECISION", "False", "NUM_GPUS", "1")
TOL = dict(atol=1e-4, rtol=1e-4)
LR = 0.05


def tiny_cfg(name, *opts):
    cfg = jax_get_cfg()
    cfg.merge_from_file(str(YAMLS[name]))
    cfg.merge_from_list(list(TINY + ("RESNET.NUM_BLOCK_TEMP_KERNEL", BLOCK_TEMP[name]) + opts))
    return cfg


def _batch(seed, b=2, classes=6):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, 16, 4), np.float32)
    mask = np.zeros((b, 16), bool)
    for i, n in enumerate((3, 1)[:b]):
        xy = rng.uniform(0, 20, (n, 2))
        boxes[i, :n] = np.concatenate([xy, np.minimum(xy + rng.uniform(6, 16, (n, 2)), 31)], 1)
        mask[i, :n] = True
    boxes[0, 0, 2:] = 31.0  # clamped at the crop's bottom-right edge
    labels = (rng.uniform(size=(b, 16, classes)) < 0.4).astype(np.float32) * mask[..., None]
    return {"frames": rng.integers(0, 256, (b, 8, 32, 32, 3), np.uint8),
            "boxes": boxes, "box_mask": mask, "labels": labels}


def _jax_inputs(cfg, frames, dtype=np.float32):
    x = jsteps.make_eval_preprocess_fn(cfg)(jnp.asarray(frames))
    return jsteps.pack_pathways(cfg, x.astype(dtype))


_SHAPES = {}


def _variables(name, cfg, jmodel, seed, dtype=np.float32):
    if name not in _SHAPES:
        b = _batch(0)
        _SHAPES[name] = jax.eval_shape(
            lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False,
                                  boxes=b["boxes"], box_mask=b["box_mask"]),
            _jax_inputs(cfg, b["frames"]))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                  draw_variables(dict(_SHAPES[name]), seed))


def _assert_stats(model, batch_stats):
    want = state_dict_from_jax({"params": {}, "batch_stats": numpy_tree(batch_stats)})
    got = model.state_dict()
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-4, atol=2e-5,
                                       err_msg=key)


def _rel_l2(got, want):
    diff = sum(float((got[k] - v).square().sum()) for k, v in want.items())
    return (diff / sum(float(v.square().sum()) for v in want.values())) ** 0.5


@pytest.mark.parametrize("name", ["slowfast", "slow"])
def test_eval_forward_matches_jax(name):
    cfg = tiny_cfg(name)
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    variables = _variables(name, cfg, jmodel, 3)
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    load_jax_params(model, variables)
    assert model.head.projection.weight.shape == (6, 256 + 32 if name == "slowfast" else 256)
    batch = _batch(1)
    want = jax.jit(lambda v, x, bx, m: jmodel.apply(v, x, train=False, boxes=bx, box_mask=m))(
        variables, _jax_inputs(cfg, batch["frames"]), batch["boxes"], batch["box_mask"])
    step = psteps.make_detection_eval_step(port_cfg(cfg), model, device="cpu")
    got = step(batch["frames"], batch["boxes"], batch["box_mask"])
    assert got.shape == (2, 16, 6) and float(got[0, :3].min()) > 0.0
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    assert float(got[~torch.from_numpy(batch["box_mask"])].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["slowfast", "slow"])
def test_train_step_matches_jax_in_float64(name):
    cfg = tiny_cfg(name, "MODEL.DROPOUT_RATE", "0.0")
    batch = _batch(2)
    variables = _variables(name, cfg, jax_build_model(cfg, dtype=jnp.float32), 4, np.float64)
    with jax.enable_x64(True):
        jmodel = jax_build_model(cfg, dtype=jnp.float64)
        tx = joptim.construct_optimizer(variables["params"], cfg)
        jstate = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jstate, jm = jax.jit(jsteps.make_detection_train_step(cfg, jmodel, tx))(
            jstate, jbatch, jax.random.PRNGKey(0), LR)
        jm = {k: np.asarray(v) for k, v in jm.items()}
        want = state_dict_from_jax(numpy_tree({"params": jstate.params,
                                               "batch_stats": jstate.batch_stats}))
    pcfg = port_cfg(cfg)
    model = build_model(pcfg, device="cpu", dtype=torch.float64)
    load_jax_params(model, variables)
    model.double()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(pcfg, device="cpu")
    m = step(init_state(pcfg, model), batch, LR)
    assert float(jm["loss"]) > 0.1 and not bool(m["nan"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert float(m["top1_err"]) == float(m["top5_err"]) == 0.0
    got = model.state_dict()
    names = [k for k in want if "running" not in k and not k.endswith("num_batches_tracked")]
    assert _rel_l2({k: before[k] - got[k] for k in names},
                   {k: before[k] - want[k] for k in names}) < 1e-4
    _assert_stats(model, jstate.batch_stats)


PARAMS = {"slowfast": 33_828_888, "slow": 31_798_416}


@pytest.mark.parametrize("name", ["slowfast", "slow"])
def test_full_size_yaml_matches_the_jax_tree(name):
    from pmv_tpu_torch.config import get_cfg

    cfg = jax_get_cfg()
    cfg.merge_from_file(str(YAMLS[name]))
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    t = cfg.DATA.NUM_FRAMES
    x = jax.ShapeDtypeStruct((1, t, 224, 224, 3), jnp.float32)
    xs = [jax.ShapeDtypeStruct((1, t // 4, 224, 224, 3), jnp.float32), x] \
        if name == "slowfast" else x
    boxes = jax.ShapeDtypeStruct((1, 16, 4), jnp.float32)
    mask = jax.ShapeDtypeStruct((1, 16), jnp.bool_)
    shapes = jax.eval_shape(lambda x, b, m: jmodel.init(jax.random.PRNGKey(0), x, train=False,
                                                        boxes=b, box_mask=m), xs, boxes, mask)
    expected = _jax_names_and_shapes(shapes["params"], shapes["batch_stats"])
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    pcfg = get_cfg()
    pcfg.merge_from_file(str(YAMLS[name]))
    with torch.device("meta"):
        model = MODEL_REGISTRY.get(pcfg.MODEL.MODEL_NAME)(pcfg)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == expected
    assert sum(p.numel() for p in model.parameters()) == n_jax == PARAMS[name]
    assert got["head.projection.weight"] == (80, 2048 + 256 if name == "slowfast" else 2048)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    model.load_state_dict(state_dict_from_jax(zeros), strict=True, assign=True)


def test_loss_divides_by_the_valid_boxes():
    """The padded rows count nowhere: the loss is the mean over the valid
    boxes of the per-box mean BCE, 0 boxes giving 0 (not NaN)."""
    rng = np.random.default_rng(0)
    preds = torch.from_numpy(rng.normal(size=(2, 16, 6)))
    labels = torch.from_numpy((rng.uniform(size=(2, 16, 6)) < 0.5).astype(np.float64))
    mask = torch.zeros(2, 16, dtype=torch.bool)
    mask[0, :3] = mask[1, 0] = True
    per_box = torch.nn.functional.binary_cross_entropy_with_logits(
        preds, labels, reduction="none").mean(-1)
    torch.testing.assert_close(psteps.detection_loss(preds, labels, mask),
                               per_box[mask].float().mean())
    assert float(psteps.detection_loss(preds, labels, torch.zeros_like(mask))) == 0.0


def test_head_dropout_applies_the_jax_mask():
    """The RoI head in training at dropout 0.5: the keep mask the JAX head
    draws from a key ([B x M, C]) handed to the port's head."""
    rng = np.random.default_rng(4)
    x = [jnp.asarray(rng.normal(size=(2, 2, 4, 4, 8)).astype(np.float32)),
         jnp.asarray(rng.normal(size=(2, 8, 4, 4, 2)).astype(np.float32))]
    batch = _batch(5)
    boxes, mask = batch["boxes"] / 2, batch["box_mask"]
    jhead = JaxRoIHead(num_classes=6, resolution=4, spatial_scale_factor=8, dropout_rate=0.5)
    variables = draw_variables(dict(jax.eval_shape(
        lambda: jhead.init(jax.random.PRNGKey(0), x, boxes, mask, train=False))), 6)
    key = jax.random.PRNGKey(7)
    want = jhead.apply(variables, x, boxes, mask, train=True, rngs={"dropout": key})
    (keep,) = jax_dropout_masks(jhead, variables, x, key, boxes=boxes, box_mask=mask)
    assert keep.shape == (32, 10) and 0 < keep.mean() < 1
    head = ResNetRoIHead([8, 2], 6, resolution=4, spatial_scale_factor=8, dropout_rate=0.5)
    head.load_state_dict(state_dict_from_jax({"projection": variables["params"]["projection"]}))
    got = head.train()([torch.from_numpy(np.asarray(t)) for t in x], torch.from_numpy(boxes),
                       torch.from_numpy(mask), torch.from_numpy(keep.astype(np.float32)))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_ava_colour_augmentation_matches_jax():
    cfg = tiny_cfg("slowfast", "AVA.TRAIN_USE_COLOR_AUGMENTATION", "True",
                   "AVA.TRAIN_PCA_JITTER_ONLY", "False")
    frames = np.random.default_rng(8).integers(0, 256, (3, 4, 8, 8, 3), np.uint8)
    key = jax.random.PRNGKey(11)
    want = jsteps.make_preprocess_fn(cfg, train=True)(key, jnp.asarray(frames))
    k_cj, rest = jax.random.split(key)
    k_lj, _ = jax.random.split(rest)
    draws = AVAColorDraws(jax_color_jitter_draws(k_cj, 3, 0.4, 0.4, 0.4, hue=0.0),
                          torch.from_numpy(np.asarray(0.1 * jax.random.normal(k_lj, (3, 3)))))
    pre = psteps.make_preprocess_fn(port_cfg(cfg), train=True, device="cpu")
    got = pre(torch.from_numpy(frames), {"ava_color": draws})
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=2e-4, rtol=1e-4)
    # PCA jitter alone: no jitter draws, the lighting shift only.
    pcfg = port_cfg(tiny_cfg("slowfast", "AVA.TRAIN_USE_COLOR_AUGMENTATION", "True"))
    pre = psteps.make_preprocess_fn(pcfg, train=True, device="cpu")
    sampled = pre.sample(frames.shape, torch.Generator().manual_seed(0), None)
    assert sampled["ava_color"].jitter is None and sampled["ava_color"].alpha.shape == (3, 3)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    root = tmp_path_factory.mktemp("ava_run")
    write_ava_dump(str(root), videos=2, frames=90, width=64, height=48, seed=1)
    return root


def _run_net_argv(name, data, out, max_epoch, *opts):
    return ["--cfg", str(YAMLS[name]), "--device", "cpu", "--opts", *TINY,
            "RESNET.NUM_BLOCK_TEMP_KERNEL", BLOCK_TEMP[name],
            "MODEL.NUM_CLASSES", "80", "AVA.FRAME_DIR", str(data / "frames"),
            "AVA.FRAME_LIST_DIR", str(data / "frame_lists"),
            "AVA.ANNOTATION_DIR", str(data / "annotations"), "DATA.NUM_FRAMES", "4",
            "DATA.TRAIN_JITTER_SCALES", "[36, 44]", "TRAIN.BATCH_SIZE", "2",
            "TEST.BATCH_SIZE", "2", "TRAIN.EVAL_PERIOD", "1", "SOLVER.MAX_EPOCH", str(max_epoch),
            "DATA_LOADER.NUM_WORKERS", "2", "OUTPUT_DIR", str(out), *opts]


def _write_kinetics_c2(path, name):
    """A Kinetics model of the yaml's trunk (DETECTION off, 7 classes) from
    a seed, written as a Caffe2 pickle of its parameters; returns the
    model's state."""
    cfg = port_cfg(tiny_cfg(name, "DETECTION.ENABLE", "False", "MODEL.NUM_CLASSES", "7",
                            "DATA.NUM_FRAMES", "4"))
    state = build_model(cfg, device="cpu", dtype=torch.float32, seed=9).state_dict()
    blobs = {_c2_name(k): v.numpy() for k, v in state.items()
             if "running" not in k and not k.endswith("num_batches_tracked")}
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    return state


def _stats(out):
    lines = (out / "stdout.log").read_text().splitlines()
    return lines, [json.loads(line.split("json_stats: ", 1)[1]) for line in lines
                   if "json_stats: " in line]


@pytest.mark.parametrize("name", ["slowfast", "slow"])
def test_run_net_trains_evaluates_tests_and_resumes(dump, tmp_path, name, one_thread):  # noqa: F811
    out = tmp_path / "job"
    opts = ("TRAIN.CHECKPOINT_TYPE", "pytorch")
    if name == "slowfast":  # the recipe's start: a Kinetics SlowFast, a Caffe2 pickle
        c2 = tmp_path / "kinetics_slowfast.pkl"
        kinetics = _write_kinetics_c2(c2, name)
        opts = ("TRAIN.CHECKPOINT_FILE_PATH", str(c2))
        args = parse_args(_run_net_argv(name, dump, out, 1, *opts))
        cfg = assert_and_infer_cfg(load_config(args, args.cfg_files[0]))
        assert cfg.TRAIN.CHECKPOINT_TYPE == "caffe2"
        model = build_model(cfg, device="cpu", seed=cfg.RNG_SEED)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        assert cu.load_train_checkpoint(cfg, init_state(cfg, model)) == 0
        for key, value in model.state_dict().items():
            want = init[key] if ("running" in key or "head" in key
                                 or key.endswith("num_batches_tracked")) else kinetics[key]
            assert torch.equal(value, want), key
    assert run_net.main(_run_net_argv(name, dump, out, 1, *opts)) == 0
    lines, stats = _stats(out)
    if name == "slowfast":
        assert any("Dropping head.projection.weight" in line for line in lines)
        assert any("kept their init" in line for line in lines)
    train = [s for s in stats if s.get("_type") == "train_epoch"]
    val = [s for s in stats if s.get("_type") == "val_epoch"]
    assert len(train) == 1 and np.isfinite(train[0]["loss"])
    assert len(val) == 1 and 0.0 <= val[0]["map"] <= 1.0
    assert stats[-1]["split"] == "test_final" and 0.0 < stats[-1]["map"] <= 1.0
    assert any("training done" in line and " map " in line for line in lines)
    ckpt = out / "checkpoints" / "checkpoint_epoch_00001.pyth"
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["model_state"]
    assert saved["head.projection.weight"].shape[0] == 80
    assert run_net.main(_run_net_argv(name, dump, out, 2, *opts)) == 0
    lines, stats = _stats(out)
    assert f"Load from last checkpoint, {ckpt}." in "\n".join(lines)
    assert "Start epoch: 2" in "\n".join(lines)
    assert stats[-1]["split"] == "test_final" and 0.0 < stats[-1]["map"] <= 1.0
