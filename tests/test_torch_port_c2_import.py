"""The port's Caffe2 checkpoint import against the JAX package's.

- ``convert_c2_name`` equal to the JAX package's on the table of
  tests/test_c2_import.py, and both load_c2_state_dicts dropping the same
  bookkeeping blobs (``_SKIP_SUBSTRINGS``, "lr" among them);
- a tiny Slow R50 and a tiny SlowFast (tests/test_torch_port_resnet.py's
  tiny config) written as Caffe2 pickles, as tests/test_c2_import.py writes
  one: parameters from one seed, BatchNorm statistics from another, and the
  optimizer's blobs; loaded through TRAIN.CHECKPOINT_TYPE caffe2 by both
  packages into models of the same init: the same parameters in both (the
  checkpoint's), the BatchNorm buffers at their init, training from epoch
  0; a head of another class count keeps its init on both sides; and
  TEST.CHECKPOINT_TYPE caffe2 loads the same parameters for testing.
"""

import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.engine.train_state import TrainState
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.utils import c2_import as jc2
from pmv_tpu.utils import checkpoint as jckpt
from pmv_tpu_torch.engine.steps import init_state
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.utils import c2_import as pc2
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax
from test_torch_port_resnet import MODELS, jax_variables, tiny_cfg
from torch_port_util import draw_variables, numpy_tree, port_cfg

# tests/test_c2_import.py's table.
NAMES = {
    "conv1_w": "s1.pathway0_stem.conv.weight",
    "res_conv1_bn_s": "s1.pathway0_stem.bn.weight",
    "res_conv1_bn_riv": "s1.pathway0_stem.bn.running_var",
    "res2_0_branch2a_w": "s2.pathway0_res0.branch2.a.weight",
    "res2_0_branch2a_bn_rm": "s2.pathway0_res0.branch2.a_bn.running_mean",
    "res3_1_branch1_w": "s3.pathway0_res1.branch1.weight",
    "res3_1_branch1_bn_b": "s3.pathway0_res1.branch1_bn.bias",
    "t_res2_0_branch2c_w": "s2.pathway1_res0.branch2.c.weight",
    "t_conv1_w": "s1.pathway1_stem.conv.weight",
    "t_pool1_subsample_w": "s1_fuse.conv_f2s.weight",
    "t_pool1_subsample_bn_s": "s1_fuse.bn.weight",
    "t_res2_3_branch2c_bn_subsample_w": "s2_fuse.conv_f2s.weight",
    "nonlocal_conv3_1_theta_w": "s3.pathway0_nonlocal1.conv_theta.weight",
    "nonlocal_conv3_1_bn_s": "s3.pathway0_nonlocal1.bn.weight",
    "pred_w": "head.projection.weight",
    "pred_b": "head.projection.bias",
}


@pytest.mark.parametrize("c2_name", sorted(NAMES))
def test_convert_c2_name_matches_jax(c2_name):
    assert pc2.convert_c2_name(c2_name) == jc2.convert_c2_name(c2_name) == NAMES[c2_name]


def test_bookkeeping_blobs_are_dropped_on_both_sides(tmp_path):
    """Blobs whose names hold "momentum", "lr" or "model_iter" (so any name
    holding the letters "lr"), 0-d blobs and object blobs are dropped."""
    blobs = {"conv1_w": np.ones((2, 3, 1, 1, 1), np.float32), "lr": np.float32(0.1),
             "model_iter": np.int64(7), "conv1_w_momentum": np.ones((2, 3, 1, 1, 1), np.float32),
             "res2_0_branch2a_w_lrx": np.ones(3, np.float32), "pred_b": np.zeros(4, np.float32),
             "scalar_b": np.float32(1.0)}
    path = tmp_path / "model.pkl"
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    got, want = pc2.load_c2_state_dict(str(path)), jc2.load_c2_state_dict(str(path))
    assert got.keys() == want.keys() == {"s1.pathway0_stem.conv.weight", "head.projection.bias"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


_LEAF = {"weight": "s", "bias": "b", "running_mean": "rm", "running_var": "riv"}


def _c2_name(name):
    """The Caffe2 blob of a PySlowFast name (the names of the ResNet
    family's stems, blocks, fusions and head)."""
    m = re.fullmatch(r"s1\.pathway(\d)_stem\.(conv|bn)\.(\w+)", name)
    if m:
        t = "t_" if m[1] == "1" else ""
        return f"{t}conv1_w" if m[2] == "conv" else f"{t}res_conv1_bn_{_LEAF[m[3]]}"
    m = re.fullmatch(r"s(\d)\.pathway(\d)_res(\d+)\.branch(1|2\.[a-c])(_bn)?\.(\w+)", name)
    if m:
        t = "t_" if m[2] == "1" else ""
        branch = m[4].replace("2.", "2")
        leaf = f"bn_{_LEAF[m[6]]}" if m[5] else "w"
        return f"{t}res{m[1]}_{m[3]}_branch{branch}_{leaf}"
    m = re.fullmatch(r"s(\d)_fuse\.(conv_f2s|bn)\.(\w+)", name)
    if m:
        base = "t_pool1_subsample" if m[1] == "1" else f"t_res{m[1]}_1_branch2c_bn_subsample"
        return f"{base}_w" if m[2] == "conv_f2s" else f"{base}_bn_{_LEAF[m[3]]}"
    return {"head.projection.weight": "pred_w", "head.projection.bias": "pred_b"}[name]


def _cfg(model, out, classes=5):
    cfg = tiny_cfg(*MODELS[model], "MODEL.NUM_CLASSES", str(classes),
                   "TRAIN.MIXED_PRECISION", "False", "OUTPUT_DIR", str(out))
    cfg.TRAIN.AUTO_RESUME = False
    return cfg


def _write_c2(path, cfg, x, seed):
    """A Caffe2 pickle of the JAX model of ``cfg``: every parameter and
    BatchNorm statistic in Caffe2's names and torch's layouts, drawn from
    ``seed``, and the optimizer's blobs. Returns the torch-named state."""
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    state = state_dict_from_jax(jax_variables(jmodel, x, seed))
    blobs = {"lr": np.float32(0.1), "model_iter": np.int64(1000)}
    for name, value in state.items():
        if not name.endswith("num_batches_tracked"):
            blobs[_c2_name(name)] = value.numpy()
            blobs[_c2_name(name) + "_momentum"] = np.zeros_like(value.numpy())
    assert all(pc2.convert_c2_name(k) == n for n, k in
               ((n, _c2_name(n)) for n in state if not n.endswith("num_batches_tracked")))
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    return state


def _inputs(cfg):
    x = jnp.zeros((1, 8, 32, 32, 3))
    return jsteps.pack_pathways(cfg, x) if cfg.MODEL.ARCH == "slowfast" else x


CASES = [("slow", False), ("slowfast", False), ("slow", True), ("slowfast", True)]


@pytest.mark.parametrize("model,other_head", CASES,
                         ids=[f"{m}-{'other_head' if h else 'same_head'}" for m, h in CASES])
def test_caffe2_train_checkpoint_loads_as_in_jax(tmp_path, model, other_head):
    cfg = _cfg(model, tmp_path / "job")
    x = _inputs(cfg)
    path = tmp_path / "model_final.pkl"
    ckpt = _write_c2(path, _cfg(model, tmp_path, 7) if other_head else cfg, x, 1)
    cfg.TRAIN.CHECKPOINT_FILE_PATH = str(path)
    cfg.TRAIN.CHECKPOINT_TYPE = "caffe2"
    cfg.TRAIN.CHECKPOINT_EPOCH_RESET = False

    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    init = draw_variables(dict(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), x, train=False))), 2)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=init["params"],
                        batch_stats=init["batch_stats"], opt_state=None)
    jstate, jstart = jckpt.load_train_checkpoint(cfg, jstate)
    want = state_dict_from_jax(numpy_tree({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}))

    pmodel = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    load_jax_params(pmodel, init)
    before = {k: v.clone() for k, v in pmodel.state_dict().items()}
    start = cu.load_train_checkpoint(port_cfg(cfg), init_state(port_cfg(cfg), pmodel))
    got = pmodel.state_dict()

    assert start == jstart == 0
    params = {n for n, _ in pmodel.named_parameters()}
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value.numpy(), err_msg=name)
        kept = name not in params or (other_head and name.startswith("head."))
        assert torch.equal(got[name], before[name] if kept else ckpt[name]), name
    assert any(not torch.equal(before[n], got[n]) for n in params)


def test_caffe2_test_checkpoint_loads_as_in_jax(tmp_path):
    cfg = _cfg("slowfast", tmp_path / "job")
    x = _inputs(cfg)
    path = tmp_path / "model_final.pkl"
    ckpt = _write_c2(path, cfg, x, 3)
    cfg.TEST.CHECKPOINT_FILE_PATH = str(path)
    cfg.TEST.CHECKPOINT_TYPE = "caffe2"
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    init = draw_variables(dict(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), x, train=False))), 4)
    jstate = jckpt.load_test_checkpoint(cfg, TrainState(
        step=jnp.zeros((), jnp.int32), params=init["params"], batch_stats=init["batch_stats"],
        opt_state=None))
    want = state_dict_from_jax(numpy_tree({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}))
    pmodel = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    load_jax_params(pmodel, init)
    assert cu.load_test_checkpoint(port_cfg(cfg), pmodel) == str(path)
    got = pmodel.state_dict()
    params = {n for n, _ in pmodel.named_parameters()}
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value.numpy(), err_msg=name)
        if name in params:
            assert torch.equal(got[name], ckpt[name]), name
