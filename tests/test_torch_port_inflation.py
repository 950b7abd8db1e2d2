"""2D->3D checkpoint inflation and the UniFormer pretrain registry against
the JAX package's importer (`pmv_tpu/utils/torch_import.py`,
`pmv_tpu/utils/pretrain.py`), on the CPU.

- One seeded image checkpoint a model, in the reference's 2-D layout (every
  5-D conv weight of the model written as a 4-D [O, I, H, W] kernel, a head
  of 1000 classes, BatchNorm statistics away from their init, under
  "model"), for tiny UniFormer, X3D and MViT: ``utils/checkpoint.py``
  routes it through the port's importer, whose loaded parameters equal,
  bit for bit, JAX's ``load_torch_checkpoint_params`` result mapped through
  ``utils/weights.state_dict_from_jax``; the head keeps the port's init, the
  BatchNorm statistics theirs, and the load counts as epoch -1 (training
  starts at epoch 0).
- The registry's ``resolve`` against JAX's: $PMV_PRETRAIN_ROOT, the
  bytenas mount, a direct path, and the KeyError that lists the names.
- ``run_net`` on the UniFormer-S yaml at tiny width with its own
  UNIFORMER.PRETRAIN_NAME (uniformer_small_in1k, a seeded image checkpoint
  under PMV_PRETRAIN_ROOT): the weights its first train step starts from
  equal JAX's ``pretrain.load_pretrained_params`` of the same file, and the
  step's loss and grad norm equal JAX's step on the same batch (rtol 1e-4).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.config.defaults import assert_and_infer_cfg as jax_assert_and_infer_cfg
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.utils import pretrain as jpretrain
from pmv_tpu.utils.torch_import import load_torch_checkpoint_params
from pmv_tpu_torch.data.synthetic import Synthetic
from pmv_tpu_torch.engine import steps as psteps
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils import pretrain
from pmv_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_uniformer import tiny_cfg as tiny_uniformer_cfg
from test_torch_port_x3d import tiny_x3d_cfg
from torch_port_util import numpy_tree, port_cfg

ROOT = Path(__file__).resolve().parents[1]
TINY_MVIT = str(ROOT / "configs" / "tiny_synthetic.yaml")
UNIFORMER_CFG = str(ROOT / "configs" / "Kinetics" / "UNIFORMER_S_16x4.yaml")


def _tiny_mvit_cfg():
    cfg = jax_get_cfg()
    cfg.merge_from_file(TINY_MVIT)
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]  # a 3x3x3 depthwise pool to inflate
    return cfg


CFGS = {"uniformer": tiny_uniformer_cfg, "x3d": tiny_x3d_cfg, "mvit": _tiny_mvit_cfg}


def image_checkpoint(model, path, seed, num_classes=1000):
    """``model``'s state dict as the reference's image checkpoint of it:
    every tensor drawn from ``seed``, each 5-D conv weight as its 4-D
    kernel, the head of ``num_classes``, under "model". Returns it."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, value in model.state_dict().items():
        shape = tuple(value.shape)
        if value.dim() == 5:
            shape = shape[:2] + shape[3:]
        if ("head" in name or "projection" in name) and value.dim() and (
                shape[0] == model_classes(model)):
            shape = (num_classes,) + shape[1:]
        if name.endswith("num_batches_tracked"):
            state[name] = torch.tensor(7)
        elif name.endswith("running_var"):
            state[name] = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        else:
            state[name] = torch.from_numpy((0.3 * rng.normal(size=shape)).astype(np.float32))
    torch.save({"model": state}, path)
    return state


def model_classes(model):
    head = model.head
    layer = getattr(head, "projection", head)
    return layer.weight.shape[0]


def _jax_params(cfg):
    """The JAX model's parameter tree at zeros (``jax.eval_shape``: no
    compile); the importer fills it."""
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    t, size = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    x = jnp.zeros((1, t, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda key: jmodel.init(key, x, train=False), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])


@pytest.mark.parametrize("name", sorted(CFGS))
def test_image_checkpoint_imports_as_jax_imports_it(tmp_path, name):
    cfg = CFGS[name]()
    path = tmp_path / "image.pth"
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    saved = image_checkpoint(model, path, seed=1)

    assert cu.load_checkpoint(str(path), model=model) == -1
    want = state_dict_from_jax(load_torch_checkpoint_params(str(path), cfg, _jax_params(cfg)))
    got = model.state_dict()
    params = dict(model.named_parameters())
    heads = [n for n in params if tuple(saved[n].shape) != tuple(init[n].shape)
             and saved[n].dim() == init[n].dim()]
    assert heads and all("head" in n for n in heads)
    inflated = [n for n in params if saved[n].dim() == 4 and init[n].dim() == 5]
    assert inflated
    for n in params:
        if n in heads:
            assert torch.equal(got[n], init[n]), n  # another class count: the init
            continue
        assert torch.equal(got[n], want[n]), n
        if n in inflated:
            t = init[n].shape[2]
            assert torch.equal(got[n], saved[n].unsqueeze(2).repeat(1, 1, t, 1, 1) / t), n
        else:
            assert torch.equal(got[n], saved[n]), n
    buffers = [n for n in got if n not in params]
    assert any("running_mean" in n for n in buffers) or name == "mvit"
    for n in buffers:
        assert torch.equal(got[n], init[n]), n  # the statistics keep their init


def test_registry_resolves_as_jax_resolves(tmp_path, monkeypatch):
    monkeypatch.delenv("BYTENAS_VOLUME_NAME", raising=False)
    monkeypatch.setenv("PMV_PRETRAIN_ROOT", str(tmp_path))
    for module in (pretrain, jpretrain):
        assert module.resolve("uniformer_small_in1k") == str(tmp_path / "uniformer_small_in1k.pth")
        with pytest.raises(KeyError, match="uniformer_base_k600_32x4"):
            module.resolve("uniformer_tiny")
    direct = tmp_path / "elsewhere.pth"
    direct.write_bytes(b"")
    assert pretrain.resolve(str(direct)) == jpretrain.resolve(str(direct)) == str(direct)
    monkeypatch.delenv("PMV_PRETRAIN_ROOT")
    monkeypatch.setenv("BYTENAS_VOLUME_NAME", "vol")
    assert (pretrain.model_paths() == jpretrain.model_paths()
            and pretrain.resolve("uniformer_base_in1k")
            == "/mnt/bn/vol/pretrained_model/uniformer_base_in1k.pth")


OPTS = ["UNIFORMER.EMBED_DIM", "[8,16,16,32]", "UNIFORMER.DEPTH", "[1,1,1,1]",
        "UNIFORMER.HEAD_DIM", "8", "UNIFORMER.DROP_DEPTH_RATE", "0.0",
        "AUG.ENABLE", "False", "MIXUP.ENABLE", "False", "TENSORBOARD.ENABLE", "False",
        "DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "MODEL.NUM_CLASSES", "5", "TRAIN.MIXED_PRECISION", "False",
        "TRAIN.DATASET", "synthetic", "TEST.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "8",
        "TEST.ENABLE", "False", "TRAIN.EVAL_PERIOD", "10", "DATA_LOADER.NUM_WORKERS", "1",
        "TPU.DEVICE_PREFETCH", "0", "NUM_GPUS", "1", "SOLVER.MAX_EPOCH", "1"]


def test_run_net_starts_from_the_pretrain_registry_as_jax_does(tmp_path, monkeypatch):
    monkeypatch.setattr(Synthetic, "NUM_VIDEOS", 16)  # 2 train steps
    monkeypatch.setenv("PMV_PRETRAIN_ROOT", str(tmp_path / "pretrained"))
    (tmp_path / "pretrained").mkdir()
    out = tmp_path / "job"
    argv = ["--cfg", UNIFORMER_CFG, "--device", "cpu", "--opts", *OPTS, "OUTPUT_DIR", str(out)]
    cfg = jax_get_cfg()
    cfg.merge_from_file(UNIFORMER_CFG)
    cfg.merge_from_list(OPTS + ["OUTPUT_DIR", str(out)])
    cfg = jax_assert_and_infer_cfg(cfg)
    assert cfg.UNIFORMER.PRETRAIN_NAME == "uniformer_small_in1k"  # the yaml's own
    image_checkpoint(build_model(port_cfg(cfg), device="cpu"),
                     tmp_path / "pretrained" / "uniformer_small_in1k.pth", seed=2, num_classes=5)

    first = {}
    make_train_step = psteps.make_train_step

    def spy(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def spied(state, batch, lr, draws=None):
            if not first:
                first.update(weights={k: v.clone() for k, v in state.model.state_dict().items()},
                             batch={k: np.asarray(torch.as_tensor(v)) for k, v in batch.items()},
                             lr=lr)
                metrics = step(state, batch, lr, draws)
                first["metrics"] = {k: float(v) for k, v in metrics.items()}
                return metrics
            return step(state, batch, lr, draws)

        spied.__dict__.update(step.__dict__)
        return spied

    monkeypatch.setattr(psteps, "make_train_step", spy)
    assert run_net.main(argv) == 0
    assert "Loading UniFormer pretrain 'uniformer_small_in1k'" in (out / "stdout.log").read_text()

    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    batch = {"frames": jnp.asarray(first["batch"]["frames"]),
             "labels": jnp.asarray(first["batch"]["labels"])}
    state, tx = jsteps.init_state(cfg, jmodel, batch, jax.random.PRNGKey(0))
    state = state.replace(params=jpretrain.load_pretrained_params(cfg, state.params))
    want = state_dict_from_jax(numpy_tree({"params": state.params,
                                           "batch_stats": state.batch_stats}))
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(first["weights"][name], value), name
    _, metrics = jax.jit(jsteps.make_train_step(cfg, jmodel, tx))(
        state, batch, jax.random.PRNGKey(0), first["lr"])
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(first["metrics"][key], float(metrics[key]), rtol=1e-4)
