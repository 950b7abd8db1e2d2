"""The port's MaskFeat training path against the JAX package's, on the CPU in
float32.

- One masked train step (``engine/ssl_steps.py``) against the jitted JAX
  ``make_masked_train_step`` from the same parameters, frames and loader
  mask, with the JAX package's HOG bins held: loss, grad norm (atol 2e-4,
  rtol 1e-4), the gradients (relative L2 1e-4; JAX's read back from its
  Adam first moment, so that its step compiles once) and the weights after the
  clip at 0.02 and AdamW (atol 2e-4); a step without a loader mask draws
  the model's own.
- The weight-decay mask and the layer-decay scales on MaskMViT's names,
  against the JAX package's on its tree.
- The loader's mask (AUG.GEN_MASK_LOADER): a Kinetics train sample's mask
  is the JAX package's ``gen_mask`` drawn last from the sample's
  generator, as the JAX package draws it; the collate (equal to JAX's) and
  the prefetcher carry it; the step takes it in place of its own draw.
- ``run_net --device cpu`` on ``configs/tiny_maskfeat_synthetic.yaml``:
  train_ssl trains, checkpoints and resumes; then the fine-tuning yaml
  from that checkpoint loads every backbone tensor that matches by name and
  shape (the rest keep their init, no optimizer state comes over) and
  trains and tests; VIS_MASK writes its comparison stacks; a contrastive
  model on MaskMViT's arch, SSL under fsdp and a run without ``--device
  cpu`` on a machine without CUDA raise.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pmv_tpu.data import loader as jloader
from pmv_tpu.data import masking as jmasking
from pmv_tpu.engine import ssl_steps as jssl
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.engine.train_state import TrainState
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models import optimizer as joptim
from pmv_tpu_torch.config import get_cfg
from pmv_tpu_torch.data import loader
from pmv_tpu_torch.data.build import build_dataset
from pmv_tpu_torch.engine import ssl_steps, steps
from pmv_tpu_torch.engine import test as ptest
from pmv_tpu_torch.engine.prefetch import DevicePrefetcher
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.models import optimizer as optim
from pmv_tpu_torch.models.masked import masked_loss
from pmv_tpu_torch.native import binding
from pmv_tpu_torch.parallel import mesh
from pmv_tpu_torch.tools import run_net
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_util import (
    finish_run_net,
    free_port,
    jax_hog_bins,
    port_cfg,
    random_params,
    start_run_net,
    tiny_maskfeat_cfg,
)
from torch_port_util import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TINY_PT = str(ROOT / "configs" / "tiny_maskfeat_synthetic.yaml")
TINY_FT = str(ROOT / "configs" / "tiny_maskfeat_ft_synthetic.yaml")
ATOL, RTOL = 2e-4, 1e-4
LR = 1e-4
pytestmark = pytest.mark.usefixtures("one_thread")


def _step_cfg(crop=32):
    """The tiny MaskMViT with the PT recipe's step: no augmentation but the
    normalisation, AdamW, the grad norm clipped at 0.02."""
    cfg = tiny_maskfeat_cfg(crop=crop)
    cfg.AUG.ENABLE = True
    cfg.AUG.AA_TYPE = ""
    cfg.AUG.RE_PROB = 0.0
    cfg.SOLVER.OPTIMIZING_METHOD = "adamw"
    cfg.SOLVER.BASE_LR = LR
    cfg.SOLVER.WEIGHT_DECAY = 0.05
    cfg.SOLVER.ZERO_WD_1D_PARAM = True
    cfg.SOLVER.CLIP_GRAD_L2NORM = 0.02
    return cfg


def _jax_model_and_params(cfg, seed=1):
    """The JAX MaskMViT and its parameters, drawn with numpy on the shapes of
    its init (``jax.eval_shape``)."""
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    crop = cfg.DATA.TRAIN_CROP_SIZE
    shapes = jax.eval_shape(lambda x: jmodel.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, x, train=False),
        jax.ShapeDtypeStruct((1, cfg.DATA.NUM_FRAMES, crop, crop, 3), jnp.float32))
    return jmodel, random_params(shapes["params"], seed)


def _batch(b, crop, seed, n_tok=None):
    rng = np.random.default_rng(seed)
    batch = {"frames": rng.integers(0, 256, (b, 4, crop, crop, 3), np.uint8)}
    if n_tok:
        batch["mask"] = rng.uniform(size=(b, n_tok)) < 0.4
    return batch


def _adam_first_moment(state):
    """The ``mu`` tree of the optax chain's one ``scale_by_adam`` state."""
    is_adam = lambda s: isinstance(s, optax.ScaleByAdamState)  # noqa: E731
    found = [s for s in jax.tree_util.tree_leaves(state.opt_state, is_leaf=is_adam)
             if is_adam(s)]
    assert len(found) == 1
    return found[0].mu


def test_masked_train_step_matches_jax():
    cfg = _step_cfg()
    batch = _batch(2, 32, 0, n_tok=128)
    jmodel, params = _jax_model_and_params(cfg)
    tx = joptim.construct_optimizer(params, cfg)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                        opt_state=tx.init(params))
    jstep = jssl.make_masked_train_step(cfg, jmodel, tx)
    preprocess = jsteps.make_preprocess_fn(cfg, train=True)
    rng = jax.random.PRNGKey(3)

    def step_and_input(state, batch):
        """The JAX step, and the input its preprocessing gave the model."""
        k_pre = jax.random.split(jax.random.fold_in(rng, 0), 3)[0]
        return jstep(state, batch, rng, LR), preprocess(k_pre, batch["frames"])

    (jstate, jm), x = jax.jit(step_and_input)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    # The gradients the JAX step took, read back from its Adam first moment
    # after one step from zero: mu = (1 - b1) * g * min(1, clip / |g|).
    b1 = cfg.SOLVER.BETAS[0]
    clip = min(1.0, cfg.SOLVER.CLIP_GRAD_L2NORM / float(jm["grad_norm"]))
    jgrads = state_dict_from_jax(jax.tree_util.tree_map(
        lambda mu: np.asarray(mu, np.float64) / ((1 - b1) * clip), _adam_first_moment(jstate)))
    bins = jax_hog_bins(x)

    pcfg = port_cfg(cfg)
    model = build_model(pcfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    state = ssl_steps.init_masked_state(pcfg, model)
    step = ssl_steps.make_masked_train_step(pcfg, device="cpu")
    m = step(state, batch, LR, {"hog_bins": torch.tensor(bins)})

    assert set(m) == set(jm) and not bool(m["nan"]) and state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), atol=ATOL,
                               rtol=RTOL)
    assert float(m["grad_norm"]) > cfg.SOLVER.CLIP_GRAD_L2NORM  # the clip acts
    grads = {k: p.grad for k, p in model.named_parameters()}
    diff = sum(float((grads[k].double() - v).square().sum()) for k, v in jgrads.items())
    assert (diff / sum(float(v.square().sum()) for v in jgrads.values())) ** 0.5 < 1e-4
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=ATOL, rtol=0,
                                   err_msg=name)
    assert sum(int((got[k] != v).sum()) for k, v in state_dict_from_jax(params).items()) > 0

    # Without a loader mask the step draws the model's: int(128 * 0.4) a row.
    draws = step.sample_draws(model, batch["frames"].shape, step=1)
    assert (draws["mask"].sum(dim=1) == 51).all()
    m = step(state, {"frames": batch["frames"]}, LR)
    assert np.isfinite(float(m["loss"])) and state.step == 2


def test_optimizer_masks_on_maskmvit_names_match_jax():
    cfg = _step_cfg()
    cfg.MASK.PRED_HOG = False
    cfg.MASK.DECODER_DEPTH = 1
    cfg.MASK.DEC_KV_KERNEL, cfg.MASK.DEC_KV_STRIDE = [3, 3, 3], [1, 2, 2]
    cfg.MASK.DECODER_SEP_POS_EMBED = True
    cfg.SOLVER.LAYER_DECAY = 0.75
    cfg.MVIT.ZERO_DECAY_POS_CLS = True
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda x: jmodel.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, x, train=False),
        jax.ShapeDtypeStruct((1, 4, 32, 32, 3), jnp.float32))["params"]
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    for jax_tree, port in ((joptim.make_wd_mask(shapes, cfg), optim.make_wd_mask(model, cfg)),
                           (joptim.make_layer_decay_scales(shapes, cfg),
                            optim.make_layer_decay_scales(model, cfg))):
        want = {k: float(np.asarray(v)) for k, v in state_dict_from_jax(
            jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), jax_tree)).items()}
        assert {k: float(v) for k, v in port.items()} == want
    scales = optim.make_layer_decay_scales(model, cfg)
    assert scales["backbone.blocks.1.attn.qkv.weight"] == 0.75 ** 1
    assert scales["decoder_pos_embed_spatial"] == 0.75 ** 3
    assert scales["decoder_blocks.0.attn.qkv.weight"] == 1.0


def _kinetics_mask_cfg(root):
    """Kinetics train clips of 4 frames, rect crops of 32 x 24 (portrait
    sources transposed), the loader's blockwise masks on the 2 x 8 x 6
    patch grid."""
    from pmv_tpu.config import get_cfg as jax_get_cfg

    cfg = jax_get_cfg()
    cfg.DATA.PATH_TO_DATA_DIR = str(root)
    cfg.DATA.PATH_PREFIX = str(root / "videos")
    cfg.DATA.PM_SUBSET = "_pmv"
    cfg.DATA.PATH_LABEL_SEPARATOR = ","
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_JITTER_SCALES = [40, 56]
    cfg.DATA.TRAIN_CROP_SIZE_RECT = [32, 24]
    cfg.DATA.TRAIN_CROP_SIZE_RECT_SWITCH_AUTO = True
    cfg.DATA.TRAIN_JITTER_SCALES_AUTO_ADJUST = True
    cfg.MODEL.NUM_CLASSES = 3
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.DATA_LOADER.NUM_WORKERS = 1
    cfg.AUG.GEN_MASK_LOADER = True
    cfg.AUG.MASK_WINDOW_SIZE = [2, 8, 6]
    cfg.AUG.MASK_RATIO = 0.4
    return cfg


def test_loader_masks_through_the_collate_and_the_step(tmp_path):
    from pmv_tpu.data.build import build_dataset as jax_build_dataset

    (tmp_path / "videos").mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i, (h, w) in enumerate([(96, 56), (56, 96), (80, 60), (72, 72)]):
        binding.write_test_video(tmp_path / "videos" / f"v{i}.avi",
                                 rng.integers(0, 256, (30, h, w, 3), np.uint8), fps=15)
        rows.append(f"v{i}.avi,{i % 3}")
    (tmp_path / "train_pmv.csv").write_text("\n".join(rows) + "\n")
    cfg = _kinetics_mask_cfg(tmp_path)
    pcfg = port_cfg(cfg)

    ours = build_dataset("kinetics", pcfg, "train")
    samples = []
    for i in range(len(ours)):
        sample = ours[i]
        gen = np.random.default_rng((pcfg.RNG_SEED, 0, i))  # the sample's generator
        with binding.VideoReader(ours._path_to_videos[i]) as reader:
            ours._decode_and_transform(reader, *ours._sample_params(i), gen)
        want = jmasking.gen_mask(cfg, gen).reshape(-1).astype(bool)
        assert sample["mask"].dtype == bool and sample["mask"].shape == (96,)
        np.testing.assert_array_equal(sample["mask"], want)
        samples.append(sample)
    ref = jax_build_dataset("kinetics", cfg, "train")[0]  # an unseeded draw
    assert ref["mask"].shape == samples[0]["mask"].shape and ref["mask"].dtype == bool
    got, want = loader._collate(samples[:2]), jloader._collate(samples[:2])
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])

    batch = next(iter(loader.construct_loader(pcfg, "train")))
    assert batch["mask"].shape == (2, 96) and batch["frames"].shape == (2, 4, 32, 24, 3)
    (host, device_batch), = list(DevicePrefetcher([batch], "cpu"))
    assert device_batch["mask"] is batch["mask"]

    # The step takes the loader's mask, on the 2 x 8 x 6 patch grid, in
    # place of a draw of its own.
    scfg = port_cfg(_step_cfg())
    scfg.DATA.TRAIN_CROP_SIZE_RECT = [32, 24]
    model = build_model(scfg, device="cpu", dtype=torch.float32)
    x = steps.make_preprocess_fn(scfg, train=True, device="cpu")(
        torch.as_tensor(batch["frames"]))
    with torch.no_grad():
        pred, target, mask = model(x, torch.as_tensor(batch["mask"]))
        want = float(masked_loss(pred, target, mask))
    step = ssl_steps.make_masked_train_step(scfg, device="cpu")
    m = step(ssl_steps.init_masked_state(scfg, model), device_batch, LR)
    np.testing.assert_allclose(float(m["loss"]), want, atol=ATOL, rtol=RTOL)


def _ckpt(out, epoch, task="ssl"):
    return cu.get_path_to_checkpoint(str(out), epoch, task)


def test_run_net_pretrains_resumes_and_fine_tunes_on_cpu(tmp_path):
    pt, ft = tmp_path / "pt", tmp_path / "ft"
    run_net.main(["--cfg", TINY_PT, "--device", "cpu", "--opts", "OUTPUT_DIR", str(pt)])
    first = torch.load(_ckpt(pt, 1), map_location="cpu", weights_only=True)
    steps = 64 // 8
    assert first["optimizer_state"]["param_groups"][0]["count"] == steps
    run_net.main(["--cfg", TINY_PT, "--device", "cpu", "--opts", "OUTPUT_DIR", str(pt),
                  "SOLVER.MAX_EPOCH", "2"])
    log = (pt / "stdout.log").read_text()
    assert f"Resumed SSL training from {_ckpt(pt, 1)}" in log and "Start epoch: 2" in log
    second = torch.load(_ckpt(pt, 2), map_location="cpu", weights_only=True)
    assert second["epoch"] == 1
    assert second["optimizer_state"]["param_groups"][0]["count"] == 2 * steps
    pt_state = second["model_state"]
    assert all(np.isfinite(v.numpy()).all() for v in pt_state.values())

    # The FT yaml from the PT checkpoint, restored as train() restores it.
    cfg = get_cfg()
    cfg.merge_from_file(TINY_FT)
    cfg.OUTPUT_DIR = str(ft)
    cfg.TRAIN.CHECKPOINT_FILE_PATH = _ckpt(pt, 2)
    init = build_model(cfg, device="cpu", seed=cfg.RNG_SEED)
    fresh = {k: v.clone() for k, v in init.state_dict().items()}
    state = ssl_steps.init_masked_state(cfg, init)
    assert cu.load_train_checkpoint(cfg, state) == 0  # CHECKPOINT_EPOCH_RESET
    assert state.step == 0 and not state.optimizer.state  # no PT optimizer state
    loaded = kept = 0
    for name, value in init.state_dict().items():
        src = pt_state.get("backbone." + name)
        if src is not None and src.shape == value.shape:
            assert torch.equal(value, src), name
            loaded += 1
        else:
            assert torch.equal(value, fresh[name]), name
            kept += 1
    backbone = [k for k in pt_state if k.startswith("backbone.")]
    # Kept: block 3's rel-pos tables (other sizes), the final norm and the head.
    assert loaded == len(backbone) - 2 and kept == 6

    run_net.main(["--cfg", TINY_FT, "--device", "cpu", "--opts", "OUTPUT_DIR", str(ft),
                  "TRAIN.CHECKPOINT_FILE_PATH", _ckpt(pt, 2)])
    log = (ft / "stdout.log").read_text()
    assert "Loaded 99 of the model's 105 tensors from the checkpoint" in log
    assert '"split": "test_final"' in log
    assert cu.has_checkpoint(str(ft), "ssl_eval")


def test_vis_mask_writes_its_comparison_stacks(tmp_path):
    cfg = get_cfg()
    cfg.merge_from_file(TINY_PT)
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.MASK.PRED_HOG = False
    cfg.VIS_MASK.ENABLE = True
    cfg.TEST.BATCH_SIZE = 2
    cfg.TEST.NUM_ENSEMBLE_VIEWS = cfg.TEST.NUM_SPATIAL_CROPS = 1
    paths = ptest.test(cfg, device="cpu")
    assert len(paths) == 4 and all(Path(p).exists() for p in paths)
    comp = np.load(paths[0])
    assert comp.dtype == np.uint8 and comp.shape == (2, 3, 2, 32, 32, 3)
    frames = build_dataset("synthetic", cfg, "test")[0]["frames"]
    np.testing.assert_array_equal(comp[0, 0], frames[::2])
    masked_plane = comp[0, 1].reshape(2, 8, 4, 8, 4, 3)
    assert (masked_plane == 0).all(axis=(2, 4, 5)).any()  # masked patches are blank


SSL_REFUSALS = {  # case -> (config, opts, whether run_net refuses it)
    # A contrastive model on MaskMViT's arch: no such SSL backbone (nor in JAX).
    "contrastive": (TINY_PT, ("MODEL.MODEL_NAME", "ContrastiveModel"), True),
    # SSL over several processes under dp_sp: the contrastive yaml's 8
    # processes (4 x 2), the tiny MaskFeat's 2 (1 x 2).
    "contrastive_yaml": (str(ROOT / "configs" / "contrastive_ssl" / "MoCo_SlowR50_8x8.yaml"),
                         ("TPU.SHARD_STRATEGY", "dp_sp"), False),
    "two_processes": (TINY_PT, ("NUM_GPUS", "2", "TPU.SHARD_STRATEGY", "dp_sp"), False),
}


@pytest.mark.parametrize("case", sorted(SSL_REFUSALS))
def test_unported_ssl_runs_raise(tmp_path, case):
    """A contrastive model on MaskMViT's arch raises NotImplementedError and
    writes no checkpoint; SSL under dp_sp, refused before, passes
    ``run_net.check`` on its (data, model) grid
    (tests/test_torch_port_sequence_parallel_tasks.py runs it)."""
    path, opts, refused = SSL_REFUSALS[case]
    if refused:
        with pytest.raises(NotImplementedError):
            run_net.main(["--cfg", path, "--device", "cpu", "--opts", "OUTPUT_DIR",
                          str(tmp_path), *opts])
        assert not cu.has_checkpoint(str(tmp_path), "ssl")
        return
    cfg = get_cfg()
    cfg.merge_from_file(path)
    cfg.merge_from_list(list(opts))
    run_net.check(cfg)
    world = cfg.NUM_GPUS * cfg.NUM_SHARDS
    assert [mesh.layout_of(cfg, r, world) for r in (0, world - 1)] == [
        mesh.Layout(0, world // 2, 0, 2), mesh.Layout(world // 2 - 1, world // 2, 1, 2)]


def _knn_epochs(log):
    return [json.loads(line.split("json_stats: ", 1)[1])["epoch"] for line in log.splitlines()
            if "ssl_knn_epoch" in line]


def test_run_net_pretrains_moco_and_maskfeat_under_fsdp_on_two_processes_and_resumes(
        tmp_path):
    """NUM_GPUS 2 under fsdp: MoCo (the tiny Slow of
    tests/test_torch_port_contrastive_train.py: its momentum encoder
    sharded as the online one, the kNN monitor over both ranks' shards) and
    tiny MaskFeat (MaskMViT's blocks sharded one by one), each one epoch of
    8 steps (64 videos, 4 a rank a step) and one checkpoint written whole
    by rank 0 (the queue's pointer past both ranks' keys); then a second
    call of MoCo, run while MaskFeat's first runs, that resumes from its
    checkpoint (the momentum encoder, the queue and the bank among it).
    (The 2-rank steps' numbers, and a checkpoint of each strategy resumed
    under the other, are held in tests/test_torch_port_distributed.py.)"""
    from test_torch_port_contrastive_train import MOCO_YAML, TINY_MOCO

    def start(name, epochs):
        cfg, out, opts = runs[name]
        return start_run_net([
            "--cfg", cfg, "--device", "cpu", "--init_method", f"tcp://127.0.0.1:{free_port()}",
            "--opts", "OUTPUT_DIR", str(out), *opts, "SOLVER.MAX_EPOCH", str(epochs),
            "NUM_GPUS", "2", "TPU.SHARD_STRATEGY", "fsdp"])

    def checkpoint(name, epoch):
        state = torch.load(_ckpt(runs[name][1], epoch), map_location="cpu", weights_only=True)
        assert state["optimizer_state"]["param_groups"][0]["count"] == 8 * epoch
        return state

    runs = {"moco": (MOCO_YAML, tmp_path / "moco", TINY_MOCO),
            "maskfeat": (TINY_PT, tmp_path / "maskfeat", [])}
    moco, maskfeat = start("moco", 1), start("maskfeat", 1)
    finish_run_net(moco)
    moco = start("moco", 2)
    finish_run_net(maskfeat)
    finish_run_net(moco)
    for name, (cfg_path, out, opts) in runs.items():
        log = (out / "stdout.log").read_text()
        state = checkpoint(name, 1)
        assert log.count("Saved checkpoint") == (2 if name == "moco" else 1)
        if name == "moco":
            assert int(state["model_state"]["queue_ptr"]) == (8 * 8) % 32
            assert f"Resumed SSL training from {_ckpt(out, 1)}" in log
            assert _knn_epochs(log) == [0, 1]
            checkpoint(name, 2)
        cfg = get_cfg()
        cfg.merge_from_file(cfg_path)
        cfg.merge_from_list(list(opts))
        model = build_model(cfg, device="cpu")  # whole tensors, not shards
        assert {k: v.shape for k, v in state["model_state"].items()} == {
            k: v.shape for k, v in model.state_dict().items()}


def test_run_net_refuses_without_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_net.main(["--cfg", TINY_PT, "--opts", "OUTPUT_DIR", str(tmp_path)])


def test_max_pool_decisions_hold_the_recorded_taps():
    """A max pool's taps recorded on one run are taken by another: the values
    and the gradient go to the recorded taps, and the outputs whose own
    maximum lies elsewhere are counted."""
    import torch.nn.functional as F

    from pmv_tpu_torch.models.common import max_pool_3d
    from pmv_tpu_torch.tools.grad_witness import max_pool_decisions

    pool = F.max_pool3d
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((2, 3, 6, 6, 4)))
    args = ((1, 3, 3), (1, 2, 2), (0, 1, 1))
    with max_pool_decisions() as record:
        want = max_pool_3d(x, *args)
    assert F.max_pool3d is pool and len(record.masks) == 1
    other = (x + 0.3 * torch.tensor(rng.standard_normal(x.shape))).float().requires_grad_()
    with max_pool_decisions(record) as held:
        got = max_pool_3d(other, *args)
    assert F.max_pool3d is pool
    own = max_pool_3d(other.detach(), *args)
    index = record.masks[0]
    assert held.taken_otherwise == int((pool(other.detach().permute(0, 4, 1, 2, 3), *args,
                                             return_indices=True)[1] != index).sum()) > 0
    # Each output is the input at float64's tap, at most its own maximum.
    flat = other.detach().permute(0, 4, 1, 2, 3).flatten(2)
    np.testing.assert_array_equal(
        got.detach().permute(0, 4, 1, 2, 3).flatten(2).numpy(),
        flat.gather(2, index.flatten(2)).numpy())
    assert bool((got.detach() <= own).all()) and not torch.equal(got.detach(), own)
    got.sum().backward()
    taps = torch.zeros_like(flat).scatter_add_(
        2, index.flatten(2), torch.ones(index.flatten(2).shape, dtype=flat.dtype))
    np.testing.assert_array_equal(other.grad.permute(0, 4, 1, 2, 3).flatten(2).numpy(),
                                  taps.numpy())


def test_layer_norm_and_masked_loss_keep_float64():
    """A float64 step is float64 throughout: LayerNorm and masked_loss take
    float64 inputs in float64 (float32 and bfloat16 ones in float32)."""
    import torch.nn.functional as F

    from pmv_tpu_torch.models.common import LayerNorm

    rng = np.random.default_rng(1)
    norm = LayerNorm(16)
    with torch.no_grad():
        norm.weight.copy_(torch.tensor(rng.standard_normal(16)))
        norm.bias.copy_(torch.tensor(rng.standard_normal(16)))
    x = torch.tensor(1e3 + rng.standard_normal((4, 16)))
    want = F.layer_norm(x, (16,), norm.weight.double(), norm.bias.double(), 1e-6).detach()
    got = norm(x)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=0, atol=1e-12)
    half = norm(x.bfloat16())
    assert half.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        half.detach().float().numpy(),
        F.layer_norm(x.bfloat16().float(), (16,), norm.weight, norm.bias, 1e-6)
        .bfloat16().float().detach().numpy())
    pred = torch.tensor(rng.standard_normal((2, 5, 3)))
    target = torch.tensor(rng.standard_normal((2, 5, 3)), dtype=torch.float32)
    mask = torch.tensor(rng.random((2, 5)) < 0.5)
    loss = masked_loss(pred, target, mask)
    assert loss.dtype == torch.float64
    err = ((pred - target.double()) ** 2).mean(dim=-1)
    np.testing.assert_allclose(float(loss), float((err * mask).sum() / mask.sum()), rtol=1e-15)


def test_op_witness_on_the_tiny_maskfeat_config(tmp_path):
    """tools/op_witness.py on the CPU: the float32 step's gradients against
    float64's, free and with float64's max-pool taps, and every module
    replayed alone, all within float32's rounding at this size."""
    from pmv_tpu_torch.tools import op_witness

    out = tmp_path / "op_witness.jsonl"
    assert op_witness.main(["--cfg", TINY_PT, "--cpu-only", "--seeds", "0", "--ops",
                            "--out", str(out)]) == 0
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["max_pool_outputs"] > 0  # block 1's skip pool
    for key in ("cpu_f32", "cpu_f32_f64_decisions"):
        assert rec[key]["grad_rel_l2_vs_f64"] < 1e-5
        assert abs(rec[key]["grad_norm_rel_vs_f64"]) < 1e-5
    assert rec["cpu_f32_f64_decisions"]["decisions_taken_otherwise"] >= 0
    assert {"Linear", "LayerNorm", "AttentionPool", "MultiScaleAttention", "MultiScaleBlock",
            "PatchEmbed", "MSSeparateHead"} <= set(rec["ops_by_type"])
    for readings in rec["ops_by_type"].values():
        assert all(0 <= v < 1e-5 for v in readings.values())
