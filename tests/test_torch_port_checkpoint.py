"""The port's checkpoints: the reference's ``.pyth`` layout, auto-resume
and the loading rules of the JAX package (`pmv_tpu/utils/checkpoint.py`).

At tiny MViT width, float32 on the CPU:
- a round trip restores every weight and the optimizer's state (AdamW's
  moments and step count) exactly;
- the last checkpoint is the lexicographic maximum of the names;
- auto-resume starts at the saved epoch + 1, and the step after the resume
  equals, bit for bit, the step of the run that never stopped (the draws
  are a function of the seed and the step count);
- the test chain: TEST.CHECKPOINT_FILE_PATH, then the last checkpoint, then
  TRAIN.CHECKPOINT_FILE_PATH, then the random init;
- CHECKPOINT_CLEAR_NAME_PATTERN strips names; a weight of another shape
  raises (as JAX's importer and its forward do), but the head's, which
  keeps the model's value; EPOCH_RESET starts at epoch 0;
- a checkpoint written from JAX parameters (``state_dict_from_jax``) gives
  the port the JAX eval step's scores (atol 2e-5), and the JAX package's
  torch importer reads the port's ``.pyth`` back to the same parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _mvitv2_s_cfg
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.utils import torch_import
from pmv_tpu_torch.engine.steps import init_state, make_eval_step, make_train_step
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_util import numpy_tree, port_cfg, random_params, to_np


def _cfg(tmp_path):
    cfg = port_cfg(_mvitv2_s_cfg(tiny=True))
    cfg.MVIT.DROPPATH_RATE = 0.3
    cfg.MODEL.DROPOUT_RATE = 0.5
    cfg.AUG.ENABLE = True
    cfg.AUG.AA_TYPE = "rand-m7-n1-mstd0.5-inc1"
    cfg.AUG.RE_PROB = 0.5
    cfg.OUTPUT_DIR = str(tmp_path)
    return cfg


def _state(cfg, seed=0):
    return init_state(cfg, build_model(cfg, device="cpu", dtype=torch.float32, seed=seed))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"frames": rng.integers(0, 256, (2, cfg.DATA.NUM_FRAMES, 16, 16, 3), np.uint8),
            "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, 2)}


def _same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def _same_optimizer(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    if sa["param_groups"] != sb["param_groups"] or sa["state"].keys() != sb["state"].keys():
        return False
    return all(torch.equal(sa["state"][i][k], sb["state"][i][k])
               for i in sa["state"] for k in sa["state"][i])


def test_round_trip_restores_weights_and_adamw_state(tmp_path):
    cfg = _cfg(tmp_path)
    state = _state(cfg)
    step = make_train_step(cfg, device="cpu")
    for i in range(2):
        step(state, _batch(cfg, i), 1e-3)
    path = cu.save_checkpoint(cfg.OUTPUT_DIR, state, 4, cfg)
    assert path.endswith("checkpoints/checkpoint_epoch_00005.pyth")
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"epoch", "model_state", "optimizer_state", "cfg"}

    restored = _state(cfg, seed=1)
    assert not _same_weights(restored.model, state.model)
    assert cu.load_checkpoint(path, restored) == 4
    assert _same_weights(restored.model, state.model)
    assert _same_optimizer(restored.optimizer, state.optimizer)
    assert restored.step == state.step == 2


def test_last_checkpoint_is_the_lexicographic_maximum(tmp_path):
    cfg = _cfg(tmp_path)
    state = _state(cfg)
    assert cu.get_last_checkpoint(cfg.OUTPUT_DIR) is None
    for epoch in (8, 11, 0):
        cu.save_checkpoint(cfg.OUTPUT_DIR, state, epoch, cfg)
    (tmp_path / "checkpoints" / "notes.txt").write_text("not a checkpoint")
    assert cu.get_last_checkpoint(cfg.OUTPUT_DIR).endswith("checkpoint_epoch_00012.pyth")
    assert cu.is_checkpoint_epoch(cfg, cfg.SOLVER.MAX_EPOCH - 1)


def test_resumed_step_equals_the_uninterrupted_step(tmp_path):
    cfg = _cfg(tmp_path)
    batches = [_batch(cfg, i) for i in range(3)]
    straight = _state(cfg)
    step = make_train_step(cfg, device="cpu", seed=3)
    for b in batches:
        step(straight, b, 1e-3)

    first = _state(cfg)
    step = make_train_step(cfg, device="cpu", seed=3)
    for b in batches[:2]:
        step(first, b, 1e-3)
    cu.save_checkpoint(cfg.OUTPUT_DIR, first, 0, cfg)

    resumed = _state(cfg, seed=9)
    assert cu.load_train_checkpoint(cfg, resumed) == 1  # TRAIN.AUTO_RESUME
    make_train_step(cfg, device="cpu", seed=3)(resumed, batches[2], 1e-3)
    assert resumed.step == straight.step == 3
    assert _same_weights(resumed.model, straight.model)
    assert _same_optimizer(resumed.optimizer, straight.optimizer)


def _saved(tmp_path, name, seed, cfg):
    state = _state(cfg, seed)
    path = tmp_path / name
    torch.save({"epoch": 2, "model_state": state.model.state_dict()}, path)
    return str(path), state.model


def test_test_checkpoint_priority_chain(tmp_path):
    cfg = _cfg(tmp_path / "job")
    test_path, test_model = _saved(tmp_path, "test.pyth", 1, cfg)
    train_path, train_model = _saved(tmp_path, "train.pyth", 2, cfg)
    last = _state(cfg, 3)
    cfg.TRAIN.CHECKPOINT_FILE_PATH = train_path
    cfg.TEST.CHECKPOINT_FILE_PATH = test_path

    def loaded():
        model = build_model(cfg, device="cpu", dtype=torch.float32, seed=4)
        path = cu.load_test_checkpoint(cfg, model)
        return path, model

    path, model = loaded()
    assert path == test_path and _same_weights(model, test_model)
    cfg.TEST.CHECKPOINT_FILE_PATH = ""
    path, model = loaded()
    assert path == train_path and _same_weights(model, train_model)
    cu.save_checkpoint(cfg.OUTPUT_DIR, last, 0, cfg)
    path, model = loaded()
    assert path.endswith("checkpoint_epoch_00001.pyth") and _same_weights(model, last.model)
    cfg.OUTPUT_DIR = str(tmp_path / "empty")
    cfg.TRAIN.CHECKPOINT_FILE_PATH = ""
    path, model = loaded()
    assert path is None and _same_weights(model, build_model(cfg, device="cpu", seed=4))


def test_train_checkpoint_file_clear_names_and_epoch_reset(tmp_path):
    cfg = _cfg(tmp_path / "job")
    cfg.TRAIN.AUTO_RESUME = False
    source = _state(cfg, 5).model
    renamed = {f"backbone.{k}": v for k, v in source.state_dict().items()}
    path = tmp_path / "pretrain.pyth"
    torch.save({"epoch": 6, "model_state": renamed}, path)
    cfg.TRAIN.CHECKPOINT_FILE_PATH = str(path)
    cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN = ["backbone."]
    state = _state(cfg, 6)
    assert cu.load_train_checkpoint(cfg, state) == 7
    assert _same_weights(state.model, source)
    cfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    assert cu.load_train_checkpoint(cfg, _state(cfg, 6)) == 0


def test_shape_mismatch_raises_but_the_heads_is_dropped(tmp_path):
    cfg = _cfg(tmp_path)
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=0)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    before = sd["head.projection.weight"]
    other = {k: v + 1 for k, v in sd.items()}
    other["head.projection.weight"] = torch.zeros(3, sd["head.projection.weight"].shape[1])
    other["head.projection.bias"] = torch.zeros(3)
    cu.load_model_state(model, other)
    assert torch.equal(model.head.projection.weight, before)
    assert torch.equal(model.norm.weight, sd["norm.weight"] + 1)
    # A model built for another crop has rel-pos tables of other sizes.
    other["blocks.0.attn.rel_pos_h"] = torch.zeros(5, sd["blocks.0.attn.rel_pos_h"].shape[1])
    with pytest.raises(ValueError, match="rel_pos_h"):
        cu.load_model_state(model, other)


@pytest.mark.parametrize("kind", ["orbax_dir"])
def test_unported_checkpoint_kinds_raise(tmp_path, kind):
    """caffe2 checkpoints load since they were ported
    (tests/test_torch_port_c2_import.py), 2D->3D inflation too
    (``test_inflate_imports_the_parameters_alone_from_epoch_0``)."""
    cfg = _cfg(tmp_path / "job")
    cfg.TRAIN.AUTO_RESUME = False
    path = tmp_path / "ckpt"
    path.mkdir()
    cfg.TRAIN.CHECKPOINT_FILE_PATH = str(path)
    with pytest.raises(NotImplementedError):
        cu.load_train_checkpoint(cfg, _state(cfg))


def test_inflate_imports_the_parameters_alone_from_epoch_0(tmp_path):
    """TRAIN.CHECKPOINT_INFLATE routes even the port's own checkpoint through
    the importer (``utils/torch_import.py``): its weights load, its
    optimizer state and epoch do not; a 2-D kernel is inflated over T."""
    cfg = _cfg(tmp_path / "job")
    cfg.TRAIN.AUTO_RESUME = False
    source = _state(cfg, 5)
    make_train_step(cfg, device="cpu")(source, _batch(cfg, 0), 1e-3)
    path = cu.save_checkpoint(str(tmp_path / "src"), source, 4, cfg)
    cfg.TRAIN.CHECKPOINT_FILE_PATH = path
    cfg.TRAIN.CHECKPOINT_INFLATE = True
    state = _state(cfg, 6)
    assert cu.load_train_checkpoint(cfg, state) == 0
    assert _same_weights(state.model, source.model)
    assert state.step == 0 and not state.optimizer.state_dict()["state"]

    # A 2-D patch-embed kernel loads inflated, inflation flag or not.
    image = {k: v.clone() for k, v in source.model.state_dict().items()}
    kernel = image["patch_embed.proj.weight"]
    image["patch_embed.proj.weight"] = kernel[:, :, 0] + 1
    torch.save({"model": image}, tmp_path / "image.pth")
    cfg.TRAIN.CHECKPOINT_FILE_PATH = str(tmp_path / "image.pth")
    cfg.TRAIN.CHECKPOINT_INFLATE = False
    state = _state(cfg, 6)
    assert cu.load_train_checkpoint(cfg, state) == 0
    t = kernel.shape[2]
    assert torch.equal(state.model.patch_embed.proj.weight,
                       (kernel[:, :, :1] + 1).repeat(1, 1, t, 1, 1) / t)


def test_checkpoint_from_jax_params_crosses_both_ways(tmp_path):
    jcfg = _mvitv2_s_cfg(tiny=True)
    frames = np.random.default_rng(0).integers(0, 256, (2, 2, 16, 16, 3), np.uint8)
    jmodel = jax_build_model(jcfg, dtype=jnp.float32)
    jstate, _ = jsteps.init_state(
        jcfg, jmodel, {"frames": jnp.asarray(frames), "labels": jnp.zeros(2, jnp.int32)},
        jax.random.PRNGKey(0))
    params = random_params(numpy_tree(jstate.params), 1)
    jstate = jstate.replace(params=params)
    path = tmp_path / "from_jax.pyth"
    torch.save({"epoch": 0, "model_state": state_dict_from_jax(params)}, path)

    cfg = port_cfg(jcfg)
    cfg.TEST.CHECKPOINT_FILE_PATH = str(path)
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=5)
    cu.load_test_checkpoint(cfg, model)
    got = to_np(make_eval_step(cfg, model, device="cpu")(frames))
    want = np.asarray(jax.jit(jsteps.make_eval_step(jcfg, jmodel))(jstate, frames))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

    back = torch_import.load_torch_checkpoint_params(str(path), jcfg, jstate.params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
