"""The port's contrastive SSL modules against the JAX package's, on the CPU in
float32 (atol 2e-4, rtol 1e-4 unless a case says otherwise).

- ``data/color_jitter.py``: each colour op on the same inputs and factors
  (the hue's HSV sector decisions among them, on integer pixels with ties
  between channels), ``color_jitter``, ``ssl_color_jitter`` in both modes,
  the blur, the lighting jitter and the time difference on the JAX
  package's draws (``torch_port_util.jax_ssl_color_draws``); the train
  preprocessing with the time difference, the SSL colour jitter,
  RandAugment and erasing in the JAX package's order; the sampled draws'
  ranges and rates.
- The contrastive multi-clip views of a tiny Kinetics fixture: each sample
  the JAX package's decode and crops from the same generator, and the
  loader's [B, V, T, H, W, C] batch.
- ``models/contrastive.py``: the encoder forward at tiny widths on the
  ``slow`` and ``x3d`` backbones, in eval and in train mode with the
  BatchNorm statistics, JAX's ReLUs taking the port's decisions; the six
  losses and their gradients; the EMA, queue and bank updates;
  ``knn_predict`` with a bank longer than the label list (JAX's clamped
  gather); the parameter names of the published yamls' models.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.data import color_jitter as jcj
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models import contrastive as jcm
from pmv_tpu_torch.data import color_jitter as cj
from pmv_tpu_torch.data import loader
from pmv_tpu_torch.data.build import build_dataset
from pmv_tpu_torch.engine import steps
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.models import contrastive as cm
from pmv_tpu_torch.native import binding
from pmv_tpu_torch.tools.grad_witness import relu_decisions
from pmv_tpu_torch.utils.weights import flax_path_to_torch, state_dict_from_jax
from torch_port_util import (  # noqa: F401
    draw_variables,
    jax_color_jitter_draws,
    jax_preprocess_draws,
    jax_relu_decisions,
    jax_ssl_color_draws,
    one_thread,
    port_cfg,
    random_batch_stats,
)

ROOT = Path(__file__).resolve().parents[1]
SSL_YAMLS = ROOT / "configs" / "contrastive_ssl"
TOL = dict(atol=2e-4, rtol=1e-4)
pytestmark = pytest.mark.usefixtures("one_thread")


def _frames(seed=0, shape=(4, 3, 12, 10, 3)):
    """Integer pixels in [0, 255] as float32: channels tie often, as in
    uint8 video, so that the hue's ``r == maxc`` branches are exercised."""
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------- colour ops

PER_CLIP = np.array([0.6, 1.0, 1.4, 0.0], np.float32)  # a factor per clip of 4
HUE = np.array([-0.15, 0.0, 0.07, 0.15], np.float32)


def _op_case(name, x):
    """(the JAX op on x, the port's) for one colour op on fixed factors."""
    f = PER_CLIP.reshape(4, 1, 1, 1, 1)
    tf = torch.tensor(PER_CLIP).reshape(4, 1, 1, 1, 1)
    key = jax.random.PRNGKey(7)
    t = torch.tensor(x)
    if name == "grayscale":
        return jcj.rgb_to_grayscale(x), cj.rgb_to_grayscale(t)
    if name in ("brightness", "contrast", "saturation"):
        return (getattr(jcj, f"adjust_{name}")(x, f),
                getattr(cj, f"adjust_{name}")(t, tf))
    if name == "hue":
        return (jcj.adjust_hue(x, HUE.reshape(4, 1, 1, 1)),
                cj.adjust_hue(t, torch.tensor(HUE).reshape(4, 1, 1, 1)))
    if name == "color_jitter":
        return (jcj.color_jitter(key, x, 0.6, 0.6, 0.6, 0.15),
                cj.color_jitter(t, jax_color_jitter_draws(key, 4, 0.6, 0.6, 0.6, 0.15)))
    if name == "random_grayscale":
        take = np.array(jax.random.uniform(key, (4, 1, 1, 1, 1)) < 0.5).reshape(4)
        return jcj.random_grayscale(key, x, 0.5), cj.random_grayscale(t, torch.tensor(take))
    if name == "gaussian_blur":
        sigma = np.array(jax.random.uniform(key, (4,), minval=0.1, maxval=2.0))
        return jcj.gaussian_blur(key, x), cj.gaussian_blur(t, torch.tensor(sigma))
    if name.startswith("ssl_color_jitter"):
        moco = name.endswith("mocov2")
        args = ((0.6, 0.6, 0.6), 0.15, 0.5, moco, (0.1, 2.0))
        return (jcj.ssl_color_jitter(key, x, *args),
                cj.ssl_color_jitter(t, jax_ssl_color_draws(key, 4, *args), moco))
    if name == "lighting_jitter":
        eigval = [0.2175, 0.0188, 0.0045]
        eigvec = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]]
        alpha = 0.1 * np.array(jax.random.normal(key, (4, 3)))
        return (jcj.lighting_jitter(key, x, 0.1, eigval, eigvec),
                cj.lighting_jitter(t, torch.tensor(alpha), eigval, eigvec))
    if name == "temporal_difference":
        return jcj.temporal_difference(x), cj.temporal_difference(t)
    if name == "augment_time_difference":
        take = np.array(jax.random.uniform(key, (4, 1, 1, 1, 1)) < 0.5).reshape(4)
        return (jcj.augment_time_difference(key, x, 0.5),
                cj.augment_time_difference(t, torch.tensor(take)))
    raise ValueError(name)


OPS = ("grayscale", "brightness", "contrast", "saturation", "hue", "color_jitter",
       "random_grayscale", "gaussian_blur", "ssl_color_jitter", "ssl_color_jitter_mocov2",
       "lighting_jitter", "temporal_difference", "augment_time_difference")


@pytest.mark.parametrize("name", OPS)
def test_colour_op_matches_jax(name):
    x = _frames()
    want, got = _op_case(name, x)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


def test_hue_sectors_and_negative_shifts_match_jax():
    """Every HSV sector and both signs of the shift: ``%`` must floor, as
    ``jnp.remainder`` does (``fmod`` differs below 0), and the sector
    decisions must be JAX's on the same pixels: the largest difference stays
    within a rounding of 255."""
    x = _frames(1, (6, 2, 16, 16, 3))
    x[:, 0, 0, :8] = 128.0  # gray pixels: no hue
    delta = np.linspace(-0.49, 0.49, 6, dtype=np.float32).reshape(6, 1, 1, 1)
    want = np.asarray(jcj.adjust_hue(x, delta))
    got = cj.adjust_hue(torch.tensor(x), torch.tensor(delta)).numpy()
    assert np.abs(got - want).max() < 1e-3
    assert np.abs(got - x).max() > 100  # the shifts move the hues
    np.testing.assert_array_equal(got[:, 0, 0, :8], x[:, 0, 0, :8])


def test_sampled_colour_draws_are_in_range():
    gen = torch.Generator().manual_seed(0)
    d = cj.sample_ssl_color_jitter(4000, gen, (0.6, 0.6, 0.6), 0.15, 0.2, True, (0.1, 2.0))
    for f in (d.jitter.brightness, d.jitter.contrast, d.jitter.saturation):
        assert 0.4 <= float(f.min()) and float(f.max()) <= 1.6
    assert -0.15 <= float(d.jitter.hue.min()) and float(d.jitter.hue.max()) <= 0.15
    assert 0 <= d.jitter.order < 24
    assert 0.1 <= float(d.sigma.min()) and float(d.sigma.max()) <= 2.0
    for coin, p in ((d.gray, 0.2), (d.apply_jitter, 0.8), (d.apply_blur, 0.5)):
        assert abs(float(coin.float().mean()) - p) < 0.03
    plain = cj.sample_ssl_color_jitter(8, gen)
    assert plain.apply_jitter is None and plain.sigma is None
    assert [d.rows(2, 5).gray.tolist(), d.rows(2, 5).jitter.order] == [d.gray[2:5].tolist(),
                                                                      d.jitter.order]


def _preprocess_cfg():
    cfg = jax_get_cfg()
    cfg.merge_from_file(str(SSL_YAMLS / "MoCo_SlowR50_8x8.yaml"))
    cfg.DATA.TIME_DIFF_PROB = 0.5
    cfg.AUG.ENABLE = True
    cfg.AUG.AA_TYPE = "rand-m7-n2-mstd0.5-inc1"
    cfg.AUG.RE_PROB = 0.5
    cfg.DATA.USE_BGR_ORDER = True
    return cfg


def test_train_preprocess_takes_the_jax_order():
    """BGR, time difference, SSL colour, RandAugment, normalise, erasing."""
    cfg = _preprocess_cfg()
    frames = np.random.default_rng(3).integers(0, 256, (4, 4, 16, 16, 3), np.uint8)
    key = jax.random.PRNGKey(5)
    want = jsteps.make_preprocess_fn(cfg, train=True)(key, jnp.asarray(frames))
    draws = jax_preprocess_draws(cfg, key, frames.shape)
    assert set(draws) == {"time_diff", "ssl_color", "rand_augment", "erasing"}
    pre = steps.make_preprocess_fn(port_cfg(cfg), train=True, device="cpu")
    got = pre(torch.tensor(frames), draws)
    _close(got, want, atol=2e-3, rtol=1e-4)  # after normalisation: 1/(0.225 * 255) a level
    # Its own draws: every one the config asks for, cut to a rank's rows.
    sample = steps.make_draw_sampler(pre, 0, torch.device("cpu"))
    own = sample(frames.shape, {}, 0, {})
    assert set(own) == set(draws)
    rows = steps.local_draws(own, 2, 4, 4)
    assert rows["time_diff"].tolist() == own["time_diff"][2:].tolist()
    assert rows["ssl_color"].gray.tolist() == own["ssl_color"].gray[2:].tolist()
    assert pre(torch.tensor(frames[2:]), rows).shape == (2, 4, 16, 16, 3)


def test_ava_colour_branch_still_raises():
    """The AVA colour branch (ported with detection; its parity with JAX is
    tests/test_torch_port_detection.py's) samples its draws, cut to a
    rank's rows like the others; applied without them it raises."""
    cfg = _preprocess_cfg()
    cfg.DETECTION.ENABLE = True
    cfg.AVA.TRAIN_USE_COLOR_AUGMENTATION = True
    pre = steps.make_preprocess_fn(port_cfg(cfg), train=True, device="cpu")
    own = steps.make_draw_sampler(pre, 0, torch.device("cpu"))((4, 4, 16, 16, 3), {}, 0, {})
    assert own["ava_color"].alpha.shape == (4, 3) and own["ava_color"].jitter is None
    rows = steps.local_draws(own, 2, 4, 4)
    assert rows["ava_color"].alpha.tolist() == own["ava_color"].alpha[2:].tolist()
    with pytest.raises(KeyError, match="ava_color"):
        pre(torch.zeros((4, 4, 16, 16, 3), dtype=torch.uint8), {})


# ------------------------------------------------------------- multi-clip views


def _kinetics_views_cfg(root, num_temporal, num_spatial):
    cfg = jax_get_cfg()
    cfg.DATA.PATH_TO_DATA_DIR = str(root)
    cfg.DATA.PATH_PREFIX = str(root / "videos")
    cfg.DATA.PATH_LABEL_SEPARATOR = ","
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_JITTER_SCALES = [40, 56]
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE = [0.2, 0.766]
    cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE = [0.75, 1.3333]
    cfg.DATA.TRAIN_CROP_NUM_TEMPORAL = num_temporal
    cfg.DATA.TRAIN_CROP_NUM_SPATIAL = num_spatial
    cfg.MODEL.NUM_CLASSES = 3
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.DATA_LOADER.NUM_WORKERS = 1
    return cfg


@pytest.mark.parametrize("num_temporal, num_spatial", [(4, 1), (2, 2), (1, 2)])
def test_multi_clip_views_match_jax(tmp_path, num_temporal, num_spatial):
    from pmv_tpu.data.build import build_dataset as jax_build_dataset

    (tmp_path / "videos").mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i, (h, w) in enumerate([(48, 64), (64, 48), (56, 56)]):
        binding.write_test_video(tmp_path / "videos" / f"v{i}.avi",
                                 rng.integers(0, 256, (40, h, w, 3), np.uint8), fps=15)
        rows.append(f"v{i}.avi,{i % 3}")
    (tmp_path / "train.csv").write_text("\n".join(rows) + "\n")
    cfg = _kinetics_views_cfg(tmp_path, num_temporal, num_spatial)
    ours = build_dataset("kinetics", port_cfg(cfg), "train")
    theirs = jax_build_dataset("kinetics", cfg, "train")
    views = num_temporal * num_spatial
    for i in range(len(ours)):
        sample = ours[i]
        assert sample["frames"].shape == (views, 4, 32, 32, 3)
        assert sample["frames"].dtype == np.uint8
        params = ours._sample_params(i)
        got, want = [], []
        for ds, out in ((ours, got), (theirs, want)):
            with binding.VideoReader(ours._path_to_videos[i]) as reader:
                out.append(ds._decode_and_transform(reader, *params, np.random.default_rng(i)))
        (g_frames, g_pm), g_time = got[0]
        (w_frames, w_pm), w_time = want[0]
        np.testing.assert_array_equal(g_frames, w_frames)
        assert (g_pm, g_time) == (w_pm, w_time)
    batch = next(iter(loader.construct_loader(port_cfg(cfg), "train")))
    assert batch["frames"].shape == (2, views, 4, 32, 32, 3)
    assert batch["index"].shape == batch["labels"].shape == (2,)


def test_synthetic_labels_are_each_samples():
    from pmv_tpu.data.synthetic import Synthetic as JaxSynthetic

    cfg = jax_get_cfg()
    cfg.MODEL.NUM_CLASSES = 7
    ours = build_dataset("synthetic", port_cfg(cfg), "train")
    assert ours._labels == JaxSynthetic(cfg, "train")._labels
    assert ours._labels[5] == ours[5]["label"]


# ------------------------------------------------------------------- the model


def tiny_ssl_cfg(ssl_type, arch="slow", yaml="MoCo_SlowR50_8x8.yaml", *opts):
    """A published contrastive yaml's recipe (its colour jitter, its
    optimizer) on a tiny backbone: Slow R18 at width 4 (or X3D at width 4),
    4 frames of 16^2, projection 16 -> 8, queue 32, bank 64."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(str(SSL_YAMLS / yaml))
    cfg.NUM_GPUS = 1
    cfg.MODEL.ARCH = arch
    cfg.MODEL.NUM_CLASSES = 5
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 16
    if arch == "x3d":
        cfg.RESNET.TRANS_FUNC = "x3d_transform"
        cfg.X3D.DIM_C1 = 4
        cfg.X3D.DEPTH_FACTOR = 0.2
        cfg.X3D.DIM_C5 = 16
    else:
        cfg.RESNET.DEPTH = 18
        cfg.RESNET.WIDTH_PER_GROUP = 4
    cfg.CONTRASTIVE.TYPE = ssl_type
    cfg.CONTRASTIVE.DIM = 8
    cfg.CONTRASTIVE.MLP_DIM = 16
    cfg.CONTRASTIVE.QUEUE_LEN = 32
    cfg.CONTRASTIVE.LENGTH = 64
    cfg.CONTRASTIVE.SWAV_QEUE_LEN = 12
    cfg.merge_from_list(list(opts))
    return cfg


def jax_encoder(cfg, seed=0):
    """The JAX ContrastiveEncoder and its variables, drawn with numpy on the
    shapes of its init."""
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    crop = cfg.DATA.TRAIN_CROP_SIZE
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
                            jax.ShapeDtypeStruct((1, cfg.DATA.NUM_FRAMES, crop, crop, 3),
                                                 jnp.float32))
    params = draw_variables(shapes["params"], seed)
    return jmodel, {"params": params,
                    "batch_stats": random_batch_stats(shapes["batch_stats"], seed + 1)}


@pytest.mark.parametrize("arch", ["slow", "x3d"])
def test_encoder_forward_matches_jax(arch):
    cfg = tiny_ssl_cfg("simclr", arch, "MoCo_SlowR50_8x8.yaml", "CONTRASTIVE.KNN_ON", "False")
    jmodel, variables = jax_encoder(cfg)
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = np.random.default_rng(2).normal(size=(3, 4, 16, 16, 3)).astype(np.float32)

    model.eval()
    with torch.no_grad():
        got = model(torch.tensor(x))
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    _close(got, want)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-6)

    model.train()
    with relu_decisions() as decisions:
        got = model(torch.tensor(x))
    with jax_relu_decisions(decisions):
        want, updates = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    _close(got.detach(), want)
    stats = state_dict_from_jax({"params": {}, "batch_stats": updates["batch_stats"]})
    for name, value in stats.items():
        if "running" in name:
            _close(model.state_dict()[name], value, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("yaml, n_params", [
    ("MoCo_SlowR50_8x8.yaml", 40_289_472), ("SimCLR_SlowR50_8x8.yaml", 40_289_472),
    ("BYOL_SlowR50_8x8.yaml", 41_076_032), ("SwAV_Slow_R50_8x8.yaml", 40_289_472),
])
def test_published_models_have_the_jax_names_and_count(yaml, n_params):
    """The full-size encoder of each yaml, built on the meta device: the JAX
    encoder's names and shapes (``jax.eval_shape``), its parameter count,
    and the SSL state's tensors beside it."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(str(SSL_YAMLS / yaml))
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
                            jax.ShapeDtypeStruct((1, 8, 224, 224, 3), jnp.float32))
    want = {}
    for tree in (shapes["params"], shapes["batch_stats"]):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            names = [str(p.key) for p in path]
            shape = tuple(leaf.shape)
            if names[-1] == "kernel":
                shape = (shape[-1], shape[-2], *shape[:-2]) if len(shape) == 5 else shape[::-1]
            want[flax_path_to_torch(names)] = shape
    with torch.device("meta"):
        model = cm.ContrastiveModel(port_cfg(cfg))
    encoder = {n: tuple(p.shape) for n, p in model.encoder_parameters()}
    assert sum(int(np.prod(s)) for s in encoder.values()) == n_params
    got = {n: tuple(t.shape) for n, t in model.state_dict().items()
           if n.startswith(("backbone.", "projection.")) and "num_batches" not in n}
    assert got == want
    c = cfg.CONTRASTIVE
    extra = {n: tuple(t.shape) for n, t in model.state_dict().items() if n not in got
             and "num_batches" not in n and not n.startswith("momentum.")}
    expected = {"bank": (c.LENGTH, c.DIM)}
    if c.TYPE == "moco":
        expected.update(queue=(c.QUEUE_LEN, c.DIM), queue_ptr=())
    if c.TYPE == "byol":
        expected.update({"predictor.fc0.weight": (c.MLP_DIM, c.DIM),
                         "predictor.fc0.bias": (c.MLP_DIM,),
                         "predictor.fc1.weight": (c.DIM, c.MLP_DIM),
                         "predictor.fc1.bias": (c.DIM,)})
    if c.TYPE == "swav":
        expected["prototypes"] = (256, c.DIM)
    assert extra == expected
    momentum = {n.removeprefix("momentum."): tuple(t.shape)
                for n, t in model.named_buffers() if n.startswith("momentum.")}
    assert momentum == (encoder if c.TYPE in cm.MOMENTUM_TYPES else {})


# ---------------------------------------------------------------- the losses


def _unit(rng, *shape):
    z = rng.normal(size=shape).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _loss_case(name, rng):
    """(JAX loss fn of its differentiated args, port's, the args)."""
    z1, z2 = _unit(rng, 6, 8), _unit(rng, 6, 8)
    if name == "moco":
        queue = _unit(rng, 20, 8)
        return (lambda a, b: jcm.moco_loss(a, b, queue, 0.1),
                lambda a, b: cm.moco_loss(a, b, torch.tensor(queue), 0.1), (z1, z2))
    if name == "simclr":
        return (lambda a, b: jcm.simclr_loss(a, b, 0.1),
                lambda a, b: cm.simclr_loss(a, b, 0.1), (z1, z2))
    if name == "byol":
        p = rng.normal(size=(6, 8)).astype(np.float32)
        return jcm.byol_loss, cm.byol_loss, (p, z2)
    if name == "sinkhorn":
        scores = z1 @ _unit(rng, 12, 8).T
        return (lambda s: jcm.sinkhorn(s).sum(axis=0) @ np.arange(12.0, dtype=np.float32),
                lambda s: cm.sinkhorn(s).sum(dim=0) @ torch.arange(12.0), (scores,))
    if name == "swav":
        protos = rng.normal(size=(12, 8)).astype(np.float32)
        return (lambda a, b, p: jcm.swav_loss(a, b, p, 0.1),
                lambda a, b, p: cm.swav_loss(a, b, p, 0.1), (z1, z2, protos))
    if name == "mem":
        bank = _unit(rng, 30, 8)
        idx = np.array([3, 7, 0, 29, 11, 5])
        return (lambda a: jcm.mem_bank_loss(a, bank, idx, 0.07),
                lambda a: cm.mem_bank_loss(a, torch.tensor(bank), torch.tensor(idx), 0.07),
                (z1,))
    raise ValueError(name)


@pytest.mark.parametrize("name", ["moco", "simclr", "byol", "sinkhorn", "swav", "mem"])
def test_loss_and_its_gradient_match_jax(name):
    jfn, fn, args = _loss_case(name, np.random.default_rng(4))
    argnums = tuple(range(len(args)))
    want, want_grads = jax.value_and_grad(jfn, argnums)(*map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    got = fn(*ts)
    if name != "sinkhorn":  # no gradient: stop_gradient'ed in SwAV
        got.backward()
        for t, w in zip(ts, want_grads):
            _close(t.grad, w, atol=1e-5, rtol=1e-4)
    _close(got.detach(), want, atol=1e-5, rtol=1e-5)


def test_sinkhorn_matches_jax_and_is_balanced():
    scores = np.random.default_rng(5).uniform(-1, 1, (10, 6)).astype(np.float32)
    want = np.asarray(jcm.sinkhorn(jnp.asarray(scores)))
    got = cm.sinkhorn(torch.tensor(scores)).numpy()
    _close(got, want, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-2)


def test_state_updates_match_jax():
    rng = np.random.default_rng(6)
    online = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=5).astype(np.float32)]
    mom = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=5).astype(np.float32)]
    want = jcm.ema_update(online, mom, 0.994)
    got = [torch.tensor(m) for m in mom]
    cm.ema_update([torch.tensor(o) for o in online], got, 0.994)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-7, rtol=1e-6)

    queue, keys = _unit(rng, 8, 4), _unit(rng, 3, 4)
    want_q, want_ptr = jcm.queue_update(jnp.asarray(queue), jnp.int32(6), jnp.asarray(keys))
    got_q, got_ptr = torch.tensor(queue), torch.tensor(6)
    cm.queue_update(got_q, got_ptr, torch.tensor(keys))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))  # rows 6, 7, 0
    assert int(got_ptr) == int(want_ptr) == 1

    bank, feats, idx = _unit(rng, 10, 4), _unit(rng, 3, 4), np.array([9, 2, 4])
    want_b = jcm.bank_update(jnp.asarray(bank), jnp.asarray(idx), jnp.asarray(feats), 0.994)
    got_b = torch.tensor(bank)
    cm.bank_update(got_b, torch.tensor(idx), torch.tensor(feats), 0.994)
    _close(got_b, want_b, atol=1e-6, rtol=1e-6)


def test_knn_predict_clamps_bank_rows_past_the_labels_as_jax():
    """A bank of 40 rows, labels for 12 samples (as the 239,975-row bank of
    the yamls beside a 64-video Synthetic): the rows past the labels vote
    with the last label, as JAX's gather clamps; untouched rows (zeros) tie
    at 0 and are taken lowest index first."""
    rng = np.random.default_rng(7)
    bank = np.zeros((40, 8), np.float32)
    touched = np.array([0, 2, 3, 5, 8, 11, 15, 20, 33])
    bank[touched] = _unit(rng, len(touched), 8)
    labels = rng.integers(0, 5, 12)
    feats = _unit(rng, 4, 8)
    for k in (3, 10, 30):
        want = jcm.knn_predict(jnp.asarray(bank), jnp.asarray(labels), jnp.asarray(feats), 5, k)
        got = cm.knn_predict(torch.tensor(bank), torch.tensor(labels), torch.tensor(feats), 5, k)
        _close(got, want, atol=1e-4, rtol=1e-5)
    # The last label gets the untouched rows past the labels' end.
    clamped = cm.knn_predict(torch.tensor(bank), torch.tensor(labels), torch.tensor(feats),
                             5, 40)
    unclamped = cm.knn_predict(torch.tensor(bank), torch.tensor(np.r_[labels, -np.ones(28, labels.dtype)]),
                               torch.tensor(feats), 5, 40)
    assert float((clamped - unclamped)[:, labels[-1]].min()) > 0
