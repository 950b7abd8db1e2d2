"""Shared helpers of the pmv_tpu_torch parity tests (tests/test_torch_port_*).

Inputs are made with numpy from a seed and handed to both packages; weights
go from the JAX parameter tree to the port through ``state_dict_from_jax``.
This module imports no JAX at import time, so that the CUDA tests, which
run where JAX is not installed, can use it.
"""

import contextlib

import numpy as np
import pytest
import torch
import yaml

import pmv_tpu_torch.config as port_config
from pmv_tpu_torch.ops import depthwise as port_depthwise


def port_cfg(jax_cfg):
    """The port's CfgNode holding the same values as a pmv_tpu config."""
    return port_config.CfgNode(yaml.safe_load(jax_cfg.dump()))


def numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def random_params(params, seed):
    """Every parameter redrawn with numpy, large enough that rel-pos tables,
    pool kernels and norms move the outputs (norm scales near 1)."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, p):
        noise = rng.normal(size=tuple(p.shape)).astype(np.float32)
        return 1.0 + 0.1 * noise if str(path[-1].key) == "scale" else 0.3 * noise

    return jax.tree_util.tree_map_with_path(draw, params)


def random_batch_stats(batch_stats, seed):
    """BatchNorm statistics redrawn with numpy: means near 0, variances in
    [0.5, 1.5]."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, p):
        if str(path[-1].key) == "var":
            return rng.uniform(0.5, 1.5, size=tuple(p.shape)).astype(np.float32)
        return (0.3 * rng.normal(size=tuple(p.shape))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, batch_stats)


def to_np(t):
    return t.detach().float().numpy()


@pytest.fixture
def cuda_device():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 through chip_smoke.py)")
    return torch.device("cuda")


@pytest.fixture
def depthwise_calls(monkeypatch):
    """Counts the model's calls into ops.depthwise3x3x3. On the CPU the
    wrapper takes the plain version and launches nothing, so its launch
    count cannot show the path was taken; this spy can."""
    from pmv_tpu_torch.models import common

    calls = []

    def spy(x, w):
        calls.append(tuple(x.shape))
        return port_depthwise.depthwise3x3x3(x, w)

    monkeypatch.setattr(common, "depthwise3x3x3", spy)
    return calls


@pytest.fixture
def one_thread():
    """torch's intra-op threads cut to one for the test. A tiny model's step
    is thousands of small ops; beside the suite's other busy workers their
    threads wait on each other (a tiny MaskFeat run_net: 96 s under five
    busy processes, 11 s on one thread), as the 2-process CLI test's did
    (ROADMAP.md, section 3)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------------------
# The JAX package's random draws, as the port's "sample" outputs. Each helper
# repeats the key splits of the JAX function it names, so that the port's
# "apply" can be fed exactly what JAX drew.


def jax_rand_augment_draws(config_str, key, groups):
    """`RandAugment.apply_batch` (`rand_augment.py:457-484`): one key per
    group, one per layer, then (choice, magnitude, sign)."""
    import jax
    import jax.numpy as jnp
    from pmv_tpu.data import rand_augment as jra
    from pmv_tpu_torch.data.rand_augment import RandAugmentDraws

    ra = jra.RandAugment(config_str)
    op_idx, mags, negs = [], [], []
    for key_g in jax.random.split(key, groups):
        for layer_key in jax.random.split(key_g, ra.num_layers):
            k_choice, k_mag, k_sign = jax.random.split(layer_key, 3)
            op_idx.append(int(jax.random.randint(k_choice, (), 0, len(ra.ops))))
            m = ra.magnitude
            if ra.magnitude_std > 0:
                m = m + ra.magnitude_std * jax.random.normal(k_mag)
            mags.append(np.float32(jnp.clip(m, 0.0, jra._LEVEL_DENOM)))
            negs.append(bool(jax.random.uniform(k_sign) < 0.5))
    shape = (groups, ra.num_layers)
    return RandAugmentDraws(
        torch.tensor(op_idx).reshape(shape),
        torch.tensor(np.array(mags, np.float32)).reshape(shape),
        torch.tensor(negs).reshape(shape),
    )


def jax_erasing_draws(key, shape, probability, mode="pixel", min_area=0.02,
                      max_area=1 / 3, min_aspect=0.3):
    """`random_erasing` (`random_erasing.py:34-58`): six keys."""
    import math

    import jax
    import jax.numpy as jnp
    from pmv_tpu_torch.data.random_erasing import ErasingDraws

    b, _, h, w, _ = shape
    max_aspect = 1 / min_aspect
    keys = jax.random.split(key, 6)
    log_ratio = (math.log(min_aspect), math.log(max_aspect))
    apply = jax.random.uniform(keys[0], (b,)) < probability
    target_area = jax.random.uniform(keys[1], (b,), minval=min_area, maxval=max_area) * (h * w)
    aspect = jnp.exp(jax.random.uniform(keys[2], (b,), minval=log_ratio[0], maxval=log_ratio[1]))
    eh = jnp.clip(jnp.round(jnp.sqrt(target_area * aspect)), 1, h).astype(jnp.int32)
    ew = jnp.clip(jnp.round(jnp.sqrt(target_area / aspect)), 1, w).astype(jnp.int32)
    top = (jax.random.uniform(keys[3], (b,)) * (h - eh + 1)).astype(jnp.int32)
    left = (jax.random.uniform(keys[4], (b,)) * (w - ew + 1)).astype(jnp.int32)
    fill = None
    if mode == "pixel":
        fill = torch.from_numpy(np.array(jax.random.normal(keys[5], tuple(shape))))

    def t(a):
        return torch.from_numpy(np.array(a))

    return ErasingDraws(t(apply), t(top).long(), t(left).long(), t(eh).long(), t(ew).long(), fill)


def jax_mixup_draws(mixup, key, height, width):
    """`MixUp.__call__` (`mixup.py:67-94`) for a pmv_tpu MixUp: five keys,
    the box centre from the last."""
    import jax
    from pmv_tpu_torch.data.mixup import MixUpDraws

    k_apply, k_switch, k_mix, k_cut, k_box = jax.random.split(key, 5)
    use_cutmix = mixup.cutmix_alpha > 0.0 and bool(
        jax.random.uniform(k_switch) < mixup.switch_prob
    )
    lam_mix = lam_cut = np.float32(1.0)
    if mixup.mixup_alpha > 0.0:
        lam_mix = np.float32(jax.random.beta(k_mix, mixup.mixup_alpha, mixup.mixup_alpha))
    if mixup.cutmix_alpha > 0.0:
        lam_cut = np.float32(jax.random.beta(k_cut, mixup.cutmix_alpha, mixup.cutmix_alpha))
    ky, kx = jax.random.split(k_box)
    cy = int(jax.random.randint(ky, (), 0, height))
    cx = int(jax.random.randint(kx, (), 0, width))
    apply = bool(jax.random.uniform(k_apply) < mixup.mix_prob)
    return MixUpDraws(apply, use_cutmix, torch.tensor(lam_mix), torch.tensor(lam_cut), cy, cx)


def jax_dropout_masks(jmodel, variables, x, key, **kwargs):
    """The keep masks (bool, in call order) that the ``nn.Dropout`` modules of
    ``jmodel`` draw in one train-mode apply on an input of ``x``'s shape
    with ``rngs={"dropout": key}``, as the JAX train step applies it (``x``
    an array, or a list of a multi-pathway net's arrays)."""
    return [np.asarray(m) for m in jax_dropout_masks_fn(jmodel, x, **kwargs)(variables, key)]


def jax_dropout_masks_fn(jmodel, x, module_type=None, **kwargs):
    """masks(variables, key): ``jax_dropout_masks`` compiled once for every
    key. A mask depends on the key, the module's path and the shape, not on
    the values: each Dropout (each ``module_type`` module, when given: the
    JAX package's DropPath) is called once, on ones, and its output read.
    The apply is jitted: it returns the masks only, so XLA drops the rest
    of the model."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    module_type = module_type or fnn.Dropout

    def masks_of(variables, key):
        masks = []

        def interceptor(next_fun, args, call_kwargs, context):
            if isinstance(context.module, module_type) and context.method_name == "__call__":
                kept = next_fun(jnp.ones_like(args[0]), *args[1:], **call_kwargs)
                masks.append(kept != 0)
                return args[0] * kept
            return next_fun(*args, **call_kwargs)

        with fnn.intercept_methods(interceptor):
            zeros = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, jnp.float32), x)
            jmodel.apply(variables, zeros, train=True,
                         mutable=["batch_stats"], rngs={"dropout": key}, **kwargs)
        return masks

    return jax.jit(masks_of)


def jax_drop_path_masks(jmodel, variables, x, key, model, **kwargs):
    """The DropPath keep masks that the JAX package's train step draws with
    ``rngs={"dropout": key}`` on an input of ``x``'s shape, in the layout of
    the port ``model``'s ``sample_drop_path_masks``: per block, None where
    its rate is 0, else one float32 mask a residual branch, in call
    order."""
    from pmv_tpu.models.common import DropPath

    masks = iter(jax_dropout_masks_fn(jmodel, x, DropPath, **kwargs)(variables, key))
    out = []
    for _, blocks in model._stages():
        for block in blocks:
            # A kept branch's ones, [rows, ...]: a row's mask is its first value.
            drawn = [(lambda m: m.reshape(m.shape[0], -1)[:, 0])(np.asarray(next(masks)))
                     for _ in block.mask_rows]
            out.append(None if block.drop_path_rate == 0.0 else tuple(
                torch.tensor(m, dtype=torch.float32) for m in drawn))
    assert next(masks, None) is None, "the JAX model drew more DropPath masks than the port"
    return out


def folded_like(mask, shape):
    """A ReLU's decisions [B, T, H, W, C] in the layout of a JAX activation
    of ``shape``: as they are, or folded as TPU.FOLD_STEM folds the stem
    ([B, T, H / f, W / f, f * f * C]); or, of the same channels, with other
    unit axes (X3D's pooled head: [B, C] here, [B, 1, 1, 1, C] there).
    Arrays, or tracers."""
    if tuple(mask.shape) == tuple(shape):
        return mask
    if mask.shape[-1] == shape[-1]:
        return mask.reshape(shape)
    b, t, h, w, c = mask.shape
    f = int(round((shape[-1] / c) ** 0.5))
    return mask.reshape(b, t, h // f, f, w // f, f, c).transpose(
        0, 1, 2, 4, 3, 5, 6).reshape(shape)


@contextlib.contextmanager
def jax_relu_decisions(decisions):
    """Within the block (which must trace the JAX model: a jit traced
    inside it), each call of flax's ``nn.relu`` takes the decisions of the
    port's ReLUs recorded by ``tools.grad_witness.relu_decisions`` on the
    same model and batch, in call order: relu(v) = v * decision. A ReLU
    input within a rounding of 0 decides either way in float32 and moves a
    whole gradient (ROADMAP.md); with the decisions held equal what is left
    is the rounding itself. The JAX stem's ReLU under TPU.FOLD_STEM runs in
    the folded layout [B, T, H / f, W / f, f * f * C]; its decisions are
    folded the same way."""
    import flax.linen as fnn

    relu, masks = fnn.relu, iter(decisions.masks)

    def held(v):
        return v * folded_like(next(masks).cpu().numpy(), v.shape).astype(v.dtype)

    fnn.relu = held
    try:
        yield
    finally:
        fnn.relu = relu
    assert next(masks, None) is None, "the JAX model made fewer ReLU calls than the port"


def jax_color_jitter_draws(key, b, brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1):
    """`color_jitter` (`color_jitter.py:88-128`): five keys, the factors,
    the hue delta and the batch's order."""
    import jax
    from pmv_tpu_torch.data.color_jitter import ColorJitterDraws

    k_b, k_c, k_s, k_h, k_o = jax.random.split(key, 5)

    def uniform(k, lo, hi, shape=(b, 1, 1, 1, 1)):
        return torch.from_numpy(np.array(
            jax.random.uniform(k, shape, minval=lo, maxval=hi)).reshape(b))

    return ColorJitterDraws(
        uniform(k_b, max(0.0, 1 - brightness), 1 + brightness),
        uniform(k_c, max(0.0, 1 - contrast), 1 + contrast),
        uniform(k_s, max(0.0, 1 - saturation), 1 + saturation),
        uniform(k_h, -hue, hue, (b, 1, 1, 1)),
        int(jax.random.randint(k_o, (), 0, 24)),
    )


def jax_ssl_color_draws(key, b, bri_con_sat=(0.4, 0.4, 0.4), hue=0.1, p_convert_gray=0.0,
                        moco_v2_aug=False, blur_sigma=(0.1, 2.0)):
    """`ssl_color_jitter` (`color_jitter.py:197-229`): five keys; the jitter
    from the first, the grayscale coin from the third, the moco-v2 coins
    from the second and the fifth, the blur's sigma from the fourth."""
    import jax
    from pmv_tpu_torch.data.color_jitter import SSLColorDraws

    k1, k2, k3, k4, k5 = jax.random.split(key, 5)

    def coin(k, p):
        return torch.from_numpy(np.array(jax.random.uniform(k, (b, 1, 1, 1, 1)) < p).reshape(b))

    draws = SSLColorDraws(jax_color_jitter_draws(k1, b, *bri_con_sat, hue),
                          coin(k3, p_convert_gray))
    if moco_v2_aug:
        draws.apply_jitter, draws.apply_blur = coin(k2, 0.8), coin(k5, 0.5)
        draws.sigma = torch.from_numpy(np.array(
            jax.random.uniform(k4, (b,), minval=blur_sigma[0], maxval=blur_sigma[1])))
    return draws


def jax_preprocess_draws(cfg, key, shape):
    """The draws of the JAX package's train preprocessing (`steps.py:75-115`)
    from its key, for a batch of ``shape``: the time difference's coin, the
    SSL colour jitter's, RandAugment's and erasing's, each from the next
    split of the key."""
    import jax
    from pmv_tpu_torch.data.rand_augment import num_groups

    draws = {}
    b = shape[0]
    if cfg.DATA.TIME_DIFF_PROB > 0:
        k_td, key = jax.random.split(key)
        draws["time_diff"] = torch.from_numpy(np.array(
            jax.random.uniform(k_td, (b, 1, 1, 1, 1)) < cfg.DATA.TIME_DIFF_PROB).reshape(b))
    if cfg.DATA.SSL_COLOR_JITTER:
        k_cj, key = jax.random.split(key)
        draws["ssl_color"] = jax_ssl_color_draws(
            k_cj, b, tuple(cfg.DATA.SSL_COLOR_BRI_CON_SAT), cfg.DATA.SSL_COLOR_HUE,
            cfg.DATA.COLOR_RND_GRAYSCALE, cfg.DATA.SSL_MOCOV2_AUG,
            (cfg.DATA.SSL_BLUR_SIGMA_MIN[1], cfg.DATA.SSL_BLUR_SIGMA_MAX[1]))
    if cfg.AUG.ENABLE and cfg.AUG.AA_TYPE:
        k_ra, key = jax.random.split(key)
        groups = num_groups(b, cfg.AUG.RA_GROUPS)
        draws["rand_augment"] = jax_rand_augment_draws(cfg.AUG.AA_TYPE, k_ra, groups)
    if cfg.AUG.ENABLE and cfg.AUG.RE_PROB > 0:
        k_re, key = jax.random.split(key)
        draws["erasing"] = jax_erasing_draws(key=k_re, shape=shape,
                                             probability=cfg.AUG.RE_PROB, mode=cfg.AUG.RE_MODE)
    return draws


def jax_train_draws(cfg, rng, step, shape):
    """The draws of the JAX train step (`steps.py:197-199`) at ``step``
    for a batch of ``shape``: the preprocessing's from the preprocess key,
    MixUp from the mixup key. DropPath's and the head dropout's keys
    come from flax's module RNG streams and are not repeated here: tests
    run DropPath at rate 0, and read the head's masks off the model with
    ``jax_dropout_masks`` under ``jax_dropout_key``."""
    import jax
    from pmv_tpu.data.mixup import MixUp

    k_pre, k_mix, _ = jax.random.split(jax.random.fold_in(rng, step), 3)
    draws = jax_preprocess_draws(cfg, k_pre, shape)
    if cfg.MIXUP.ENABLE:
        mixup = MixUp(
            mixup_alpha=cfg.MIXUP.ALPHA, cutmix_alpha=cfg.MIXUP.CUTMIX_ALPHA,
            mix_prob=cfg.MIXUP.PROB, switch_prob=cfg.MIXUP.SWITCH_PROB,
            label_smoothing=cfg.MIXUP.LABEL_SMOOTH_VALUE,
            num_classes=cfg.MODEL.NUM_CLASSES,
        )
        draws["mixup"] = jax_mixup_draws(mixup, k_mix, shape[2], shape[3])
    return draws


def jax_ssl_step_draws(cfg, rng, step, shape):
    """The draws of the JAX contrastive step (`ssl_steps.py:176-187`) at
    ``step`` for one view of ``shape``: each view's preprocessing from its
    key."""
    import jax

    k1, k2 = jax.random.split(jax.random.fold_in(rng, step))
    return {"view1": jax_preprocess_draws(cfg, k1, shape),
            "view2": jax_preprocess_draws(cfg, k2, shape)}


def draw_variables(shapes, seed):
    """numpy draws on a tree of ``jax.eval_shape`` shapes: kernels of
    variance 1 / fan_in, norm scales near 1, variances in [0.5, 1.5], the
    rest (biases, means) small."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = str(path[-1].key), tuple(leaf.shape)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_dropout_key(rng, step):
    """The dropout key of the JAX train step at ``step`` (`steps.py:197`)."""
    import jax

    return jax.random.split(jax.random.fold_in(rng, step), 3)[2]


# ----------------------------------------------------------------------------
# MaskFeat (tests/test_torch_port_masked.py, test_torch_port_maskfeat_train.py).


def tiny_maskfeat_cfg(crop=32, pred_hog=True, decoder_depth=0, sep_pos=False):
    """MaskMViT at depth 2, width 8, 4 frames: block 0 pools q at stride 1
    (3x3x3, K1's path), block 1 at (1, 2, 2), so the tokens are up-sampled."""
    from pmv_tpu.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = "MaskMViT"
    cfg.MODEL.ARCH = "maskmvit"
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = crop
    cfg.DATA.INPUT_CHANNEL_NUM = [3]
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.EMBED_DIM = 8
    cfg.MVIT.NUM_HEADS = 1
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.USE_ABS_POS = False
    cfg.MVIT.REL_POS_SPATIAL = cfg.MVIT.REL_POS_TEMPORAL = True
    cfg.MVIT.RESIDUAL_POOLING = True
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 4, 4]
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DROPPATH_RATE = 0.0  # the PT yaml's
    cfg.AUG.MASK_RATIO = 0.4
    cfg.MASK.ENABLE = True
    cfg.MASK.PRED_HOG = pred_hog
    cfg.MASK.DECODER_DEPTH = decoder_depth
    cfg.MASK.DECODER_EMBED_DIM = 16
    cfg.MASK.DECODER_SEP_POS_EMBED = sep_pos
    cfg.MASK.DEC_NUM_HEADS = 2
    if decoder_depth:
        cfg.MASK.DEC_KV_KERNEL = [3, 3, 3]
        cfg.MASK.DEC_KV_STRIDE = [1, 2, 2]
    return cfg


def jax_hog_bins(frames, nbins=9):
    """The bins the JAX package's ``hog_targets`` takes (`masked.py:29-36`),
    as a numpy array: the side whose bins a comparison holds."""
    import jax.numpy as jnp

    gx = frames[:, :, :, 2:] - frames[:, :, :, :-2]
    gx = jnp.pad(gx, ((0, 0), (0, 0), (0, 0), (1, 1), (0, 0)))
    gy = frames[:, :, 2:] - frames[:, :, :-2]
    gy = jnp.pad(gy, ((0, 0), (0, 0), (1, 1), (0, 0), (0, 0)))
    ang = jnp.arctan2(gy, gx) % np.pi
    return np.asarray(jnp.floor(ang / (np.pi / nbins)).astype(jnp.int32) % nbins)



# ----------------------------------------------------------------------------
# Ranks of a multi-process job on the CPU (gloo), for
# tests/test_torch_port_distributed.py. The functions that run in a rank live
# here, so that a spawned rank imports torch and the port, not JAX.

RANK_TIMEOUT_S = 60  # a collective waits this long before it raises
JOIN_TIMEOUT_S = 120  # the whole spawn, after which a rank counts as hung


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(target, rank, world, port, model_size, args):
    import datetime

    from pmv_tpu_torch.parallel import distributed

    torch.set_num_threads(2)
    distributed.init_distributed(
        rank, world, f"tcp://127.0.0.1:{port}", torch.device("cpu"), "gloo",
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S), model_size=model_size)
    try:
        target(rank, world, *args)
    finally:
        distributed.destroy()


def start_ranks(target, *args, world=2, model_size=1):
    """Start ``target(rank, world, *args)`` in ``world`` spawned processes
    that form a gloo job, with the dp_sp groups of a model axis of
    ``model_size`` (``mesh.model_size`` of a dp_sp case's cfg);
    ``join_ranks`` waits for them."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, args=(target, rank, world, port, model_size, args))
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, timeout=JOIN_TIMEOUT_S):
    """Wait for the ranks; kill and fail on a rank still running after
    ``timeout`` seconds (a hang), and fail on a rank that failed."""
    import time

    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [i for i, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} still running after {timeout} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


def start_run_net(argv):
    """``python -m pmv_tpu_torch.tools.run_net`` with ``argv`` started in a
    process group of its own (a multi-process job's ranks, which it spawns,
    join the group), each process computing on one thread (OMP_NUM_THREADS
    1, which the ranks inherit): beside other test workers on a shared CPU,
    ranks whose intra-op threads claim the host's cores wait on each
    other's threads. ``finish_run_net`` waits for it."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    return subprocess.Popen([sys.executable, "-m", "pmv_tpu_torch.tools.run_net", *argv],
                            cwd=Path(__file__).resolve().parents[1], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True,
                            env={**os.environ, "OMP_NUM_THREADS": "1"})


def finish_run_net(proc, timeout=JOIN_TIMEOUT_S):
    """Wait for ``start_run_net``'s ``proc``, killed with every rank it
    spawned after ``timeout`` seconds; its output. Fails on a hang or a
    non-zero exit."""
    import os
    import signal
    import subprocess

    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"run_net {proc.args[3:]} hung")
    assert proc.returncode == 0, log[-4000:]
    return log


def local_rows(batch, rank, world):
    """Rank ``rank``'s rows of a global batch (a dict of arrays)."""
    b = len(batch["frames"]) // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def whole_state(model):
    """The model's state_dict with every sharded tensor gathered."""
    from pmv_tpu_torch.parallel import distributed

    return {k: distributed.full(v).detach().clone() for k, v in model.state_dict().items()}


def rank_train_step(rank, world, case, strategy):
    """One train step of ``case`` (cfg, state_dict, global batch, its draws,
    lr, and the activations' dtype, float32 unless it names one) on this
    rank's rows under ``strategy`` (under dp_sp, which the cfg must name,
    its data group's rows): its metrics, the whole gradients, the state
    after it, every rank's portrait route (the name of
    ``steps.portrait_route``'s choice), and the TrainState."""
    from pmv_tpu_torch.engine.steps import init_state, make_train_step, portrait_route
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.parallel import distributed, mesh

    cfg = case["cfg"]
    model = build_model(cfg, device="cpu", dtype=case.get("dtype", torch.float32))
    model.load_state_dict(case["state_dict"])
    wrapped = distributed.wrap_model(model, strategy, torch.device("cpu"))
    state = init_state(cfg, model, wrapped=wrapped)
    step = make_train_step(cfg, device="cpu")
    lay = mesh.layout(cfg)
    batch = local_rows(case["batch"], lay.data, lay.data_size)
    route, _ = portrait_route(model, batch.get("pm"), len(batch["labels"]), train=True,
                              lay=lay)
    routes = distributed.gather_host([np.array([route.__name__])])[0]
    metrics = step(state, batch, case["lr"], case["draws"])
    grads = {k: distributed.full(p.grad).clone() for k, p in model.named_parameters()}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "state": whole_state(model), "routes": list(routes)}, state


def rank_av_steps(rank, world, case, strategy=None):
    """AVSlowFast's case (cfg, state_dict, the global batches, their epochs,
    lr, dtype, the steps' seed): a train step on each batch under ``strategy`` (None: the
    model unwrapped, as one process runs it), this rank's rows of
    "audio_mis" first rolled into the easy negatives of the batch's epoch
    (``steps.easy_negatives``, across ranks). Per step: the metrics, the
    rolled clips of every rank and every rank's DropPathway decision (the
    step's ``sample_draws``); then the whole gradients and the state."""
    from pmv_tpu_torch.engine import steps
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.parallel import distributed

    cfg = case["cfg"]
    model = build_model(cfg, device="cpu", dtype=case["dtype"])
    model.load_state_dict(case["state_dict"])
    wrapped = None if strategy is None else distributed.wrap_model(
        model, strategy, torch.device("cpu"))
    state = steps.init_state(cfg, model, wrapped=wrapped)
    step = steps.make_train_step(cfg, device="cpu", seed=case["seed"])
    out = []
    for batch, epoch in zip(case["batches"], case["epochs"]):
        local = local_rows(batch, rank, world)
        local["audio_mis"] = steps.easy_negatives(cfg, local["audio_mis"], epoch)
        decision = step.sample_draws(model, batch["frames"].shape, state.step)["drop_pathway"]
        rolled, decisions = distributed.gather_host(
            [local["audio_mis"].numpy(), np.array([decision])])
        metrics = step(state, local, case["lr"])
        out.append({"metrics": {k: float(v) for k, v in metrics.items()}, "rolled": rolled,
                    "decisions": decisions.tolist()})
    grads = {k: distributed.full(p.grad).clone() for k, p in model.named_parameters()}
    return {"steps": out, "grads": grads, "state": whole_state(model)}


def rank_detection(rank, world, case, strategy=None):
    """AVA detection's case (cfg, state_dict, the global batch, lr, dtype):
    the detection train step on this rank's rows under ``strategy`` (None:
    the model unwrapped, as one process runs it), its metrics, the whole
    gradients and the state; then ``test_detection`` of the state over
    this rank's shard of the test split (the loader shards it by
    NUM_GPUS = the world size), its AVA mAP."""
    from pmv_tpu_torch.engine.steps import init_state, make_train_step
    from pmv_tpu_torch.engine.test import test_detection
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.parallel import distributed

    cfg = case["cfg"].clone()
    cfg.NUM_GPUS = world
    model = build_model(cfg, device="cpu", dtype=case["dtype"])
    model.load_state_dict(case["state_dict"])
    wrapped = None if strategy is None else distributed.wrap_model(
        model, strategy, torch.device("cpu"))
    metrics = make_train_step(cfg, device="cpu")(
        init_state(cfg, model, wrapped=wrapped), local_rows(case["batch"], rank, world),
        case["lr"])
    grads = {k: distributed.full(p.grad).clone() for k, p in model.named_parameters()}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "state": whole_state(model), "map": test_detection(cfg, model, "cpu")["map"]}


def rank_sp_case(rank, world, case):
    """The dp_sp case (cfg naming TPU.SHARD_STRATEGY dp_sp, state_dict, the
    global batch and its draws, lr, the activations' dtype, float32 unless
    it names one; optionally "eval": frames, and portrait flags or audio;
    "test": clips, labels, clips a video, rows a data group a step;
    "precise_batches": global batches) on this rank: the train step
    (``rank_train_step``) with the shapes the K1 and wgrad calls took; the
    eval step's scores on the eval frames; ``perform_test`` through the
    loader's shard of this rank's data index (the meter's scores, clip
    counts and stats); precise BN over its rows of the batches (the running
    statistics after it); each with the model of the case's weights."""
    from pmv_tpu_torch.data.loader import DataLoader
    from pmv_tpu_torch.engine.precise_bn import calculate_and_update_precise_bn
    from pmv_tpu_torch.engine.steps import init_state, make_eval_step
    from pmv_tpu_torch.engine.test import perform_test
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.ops.depthwise import record_shapes
    from pmv_tpu_torch.parallel import mesh
    from pmv_tpu_torch.utils.meters import TestMeter

    with record_shapes() as shapes:
        out, _ = rank_train_step(rank, world, case, "dp_sp")
    out["shapes"] = shapes
    cfg = case["cfg"]
    lay = mesh.layout(cfg)
    out["layout"] = lay
    dtype = case.get("dtype", torch.float32)
    if "precise_batches" in case:
        model = build_model(cfg, device="cpu", dtype=dtype)
        model.load_state_dict(case["state_dict"])
        calculate_and_update_precise_bn(
            [local_rows(b, lay.data, lay.data_size) for b in case["precise_batches"]],
            init_state(cfg, model), cfg, "cpu")
        out["precise_bn"] = {k: v.clone() for k, v in model.state_dict().items()
                             if "running" in k}
    if "eval" not in case:
        return out
    model = build_model(cfg, device="cpu", dtype=dtype)
    model.load_state_dict(case["state_dict"])
    eval_step = make_eval_step(cfg, model, device="cpu")
    rows = local_rows(case["eval"], lay.data, lay.data_size)
    with record_shapes() as shapes:
        out["scores"] = eval_step(rows["frames"], rows.get("pm"), rows.get("audio")).clone()
    out["eval_shapes"] = shapes
    if "test" not in case:
        return out
    test = case["test"]
    loader = DataLoader(ClipDataset(test["frames"], test["labels"], test["num_clips"]),
                        test["batch_size"], rank=lay.data, world_size=lay.data_size,
                        num_workers=1)
    meter = TestMeter(len(test["labels"]), test["num_clips"], cfg.MODEL.NUM_CLASSES,
                      len(loader))
    meter, stats = perform_test(loader, eval_step, meter, lay)
    out["test"] = {"stats": stats, "video_preds": meter.video_preds,
                   "clip_count": meter.clip_count, "steps": len(loader)}
    return out


def rank_sp_cases(rank, world, case_dir):
    """Each dp_sp case of ``case_dir/sp_cases.pt`` ({name: case}) on this
    rank (``rank_sp_case``), with the bytes its T collectives handed to
    ``all_reduce`` (``mesh.traffic``); rank 0 writes every rank's results
    to ``case_dir/sp_results.pt``."""
    from pathlib import Path

    from pmv_tpu_torch.parallel import mesh

    case_dir = Path(case_dir)
    cases = torch.load(case_dir / "sp_cases.pt", weights_only=False)
    out = {}
    for name, case in cases.items():
        before = dict(mesh.traffic)
        got = rank_sp_case(rank, world, case)
        got["traffic"] = {k: v - before[k] for k, v in mesh.traffic.items()}
        ranks = [None] * world
        torch.distributed.all_gather_object(ranks, got)
        out[name] = ranks
    if rank == 0:
        torch.save(out, case_dir / "sp_results.pt")


def rank_grid_case(rank, world, case_dir):
    """``case_dir/grid_case.pt``'s dp_sp steps ({name: case}) on this rank of
    a 2 x 2 grid (``rank_train_step``), and the data-axis collectives:
    every data index's rank (``distributed.gather_rows``) and the MixUp
    partner's (``distributed.partner_rows``), on each rank; rank 0 writes
    them all to ``case_dir/grid_results.pt``."""
    from pathlib import Path

    from pmv_tpu_torch.parallel import distributed, mesh

    case_dir = Path(case_dir)
    cases = torch.load(case_dir / "grid_case.pt", weights_only=False)
    out = {"steps": {name: rank_train_step(rank, world, case, "dp_sp")[0]
                     for name, case in cases.items()}}
    lay = mesh.layout(next(iter(cases.values()))["cfg"])
    mine = torch.tensor([float(rank)])
    out["layout"] = (lay.data, lay.data_size, lay.model, lay.model_size)
    out["data_axis"] = distributed.gather_rows(mine, lay).flatten().tolist()
    out["partner"] = float(distributed.partner_rows(mine, lay))
    everyone = distributed.gather_host([np.array([out["layout"]]),
                                        np.array([out["data_axis"]]),
                                        np.array([out["partner"]])])
    if rank == 0:
        out["ranks"] = [a.tolist() for a in everyone]
        torch.save(out, case_dir / "grid_results.pt")


def rank_cases(rank, world, case_dir):
    """Every case of ``case_dir/cases.pt`` on this rank; rank 0 writes the
    results to ``case_dir/results.pt``."""
    from pathlib import Path

    from pmv_tpu_torch.data.loader import DataLoader
    from pmv_tpu_torch.engine.precise_bn import calculate_and_update_precise_bn
    from pmv_tpu_torch.engine.steps import init_state, make_eval_step, make_train_step
    from pmv_tpu_torch.engine.test import perform_test
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.models.batchnorm import BatchNorm
    from pmv_tpu_torch.parallel import distributed
    from pmv_tpu_torch.utils import checkpoint as cu
    from pmv_tpu_torch.utils.meters import TestMeter

    case_dir = Path(case_dir)
    cases = torch.load(case_dir / "cases.pt", weights_only=False)
    out = {}

    # (a), (b): the dp and the fsdp step of each model.
    for name, case in cases["steps"].items():
        for strategy in ("dp", "fsdp"):
            out[name, strategy], _ = rank_train_step(rank, world, case, strategy)

    # (b): a checkpoint of one strategy resumed under the other, and a
    # second step under each.
    case = cases["resume"]
    cfg = case["cfg"].clone()
    first, second = {}, {}
    for strategy, other in (("dp", "fsdp"), ("fsdp", "dp")):
        cfg.OUTPUT_DIR = str(case_dir / strategy)
        _, state = rank_train_step(rank, world, case, strategy)
        cu.save_checkpoint(cfg.OUTPUT_DIR, state, 0, cfg)
        model = build_model(cfg, device="cpu", dtype=torch.float32)
        resumed = init_state(cfg, model, wrapped=distributed.wrap_model(
            model, other, torch.device("cpu")))
        assert cu.load_train_checkpoint(cfg, resumed) == 1
        # Copies: the optimizer's live state tensors, which the next step moves.
        opt_state = cu.full_state(resumed)[1]
        opt_state["state"] = {i: {k: v.clone() for k, v in st.items()}
                              for i, st in opt_state["state"].items()}
        first[strategy] = whole_state(resumed.model), opt_state
        step = make_train_step(cfg, device="cpu")
        step(resumed, local_rows(case["batch2"], rank, world), case["lr"], case["draws2"])
        second[strategy] = whole_state(resumed.model)
    out["resume"] = {"first": first, "second": second,
                     "files": sorted(p.name for p in (case_dir / "dp" / "checkpoints").iterdir())}

    # (c): precise BN over this rank's rows of the global batches.
    case = cases["precise_bn"]
    model = build_model(case["cfg"], device="cpu", dtype=torch.float32)
    model.load_state_dict(case["state_dict"])
    calculate_and_update_precise_bn([local_rows(b, rank, world) for b in case["batches"]],
                                    init_state(case["cfg"], model), case["cfg"], "cpu")
    out["precise_bn"] = whole_state(model)

    # (d): the multi-view test through the loader's shard of this rank.
    case = cases["test"]
    model = build_model(case["cfg"], device="cpu", dtype=torch.float32)
    model.load_state_dict(case["state_dict"])
    loader = DataLoader(ClipDataset(case["frames"], case["labels"], case["num_clips"]),
                        case["batch_size"], rank=rank, world_size=world, num_workers=1)
    meter = TestMeter(len(case["labels"]), case["num_clips"], case["cfg"].MODEL.NUM_CLASSES,
                      len(loader))
    meter, stats = perform_test(loader, make_eval_step(case["cfg"], model, device="cpu"), meter)
    out["test"] = {"stats": stats, "video_preds": meter.video_preds,
                   "clip_count": meter.clip_count, "steps": len(loader),
                   "local_batches": distributed.gather_host([[len(list(loader))]])[0]}

    # (e): the global BatchNorm, forward and backward, on this rank's rows.
    case = cases["bn"]
    bn = BatchNorm(case["x"].shape[-1])
    bn.load_state_dict(case["state_dict"])
    b = case["x"].shape[0] // world
    x = case["x"][rank * b:(rank + 1) * b].clone().requires_grad_()
    y = bn.train()(x)
    (y * case["weight"][rank * b:(rank + 1) * b]).sum().backward()
    params = [bn.weight.grad, bn.bias.grad]
    out["bn"] = {"y": distributed.gather_host([y.detach().numpy()])[0],
                 "x_grad": distributed.gather_host([x.grad.numpy()])[0],
                 "param_grads": [distributed.all_reduce_sum(g) for g in params],
                 "state": {k: v.clone() for k, v in bn.state_dict().items()}}

    # (e): SubBatchNorm's splits of the global batch, on this rank's rows.
    case = cases["sub_bn"]
    b = case["x"].shape[0] // world
    out["sub_bn"] = {}
    for splits in case["splits"]:
        bn = BatchNorm(case["x"].shape[-1], num_splits=splits)
        bn.load_state_dict(case["state_dicts"][splits])
        x = case["x"][rank * b:(rank + 1) * b].clone().requires_grad_()
        y = bn.train()(x)
        (y * case["weight"][rank * b:(rank + 1) * b]).sum().backward()
        out["sub_bn"][splits] = {
            "y": distributed.gather_host([y.detach().numpy()])[0],
            "x_grad": distributed.gather_host([x.grad.numpy()])[0],
            "param_grads": [distributed.all_reduce_sum(g) for g in (bn.weight.grad, bn.bias.grad)],
            "state": {k: v.clone() for k, v in bn.state_dict().items()}}

    # (h): AVSlowFast's steps, the AVS losses over the global batch.
    for strategy in ("dp", "fsdp"):
        out["avslowfast", strategy] = rank_av_steps(rank, world, cases["avslowfast"], strategy)

    # (i): AVA detection, the loss over the global count of boxes, the
    # gathered test.
    out["detection"] = rank_detection(rank, world, cases["detection"], "dp")

    # (j), (k): MViT and UniFormer under dp_sp, a grid of data 1 x model 2:
    # every rank's results, gathered to rank 0.
    for key in ("sp", "uniformer_sp", "uniformer_split_sp"):
        sp = rank_sp_case(rank, world, cases[key])
        sp_ranks = [None] * world
        torch.distributed.all_gather_object(sp_ranks, sp)
        out[key] = sp_ranks
    if rank == 0:
        torch.save(out, case_dir / "results.pt")


def _rank_ssl_step(rank, world, name, case, strategy):
    """One SSL step of ``case`` on this rank's rows under ``strategy``: its
    metrics, the whole gradients, the state after it, and the TrainState."""
    from pmv_tpu_torch.engine import ssl_steps
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.parallel import distributed

    cfg = case["cfg"]
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(case["state_dict"])
    wrapped = distributed.wrap_model(model, strategy, torch.device("cpu"))
    state = ssl_steps.init_ssl_state(cfg, model, wrapped=wrapped)
    make = ssl_steps.make_masked_train_step if name == "maskfeat" else \
        ssl_steps.make_ssl_train_step
    metrics = make(cfg, device="cpu")(state, local_rows(case["batch"], rank, world),
                                      case["lr"], case["draws"])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: distributed.full(p.grad).clone() for k, p in model.named_parameters()},
            "state": whole_state(model)}, state


def rank_ssl_cases(rank, world, case_dir):
    """Each SSL step of ``case_dir/ssl_cases.pt`` (cfg, state_dict, global
    batch, its draws, lr; "maskfeat" or a contrastive step) under ``dp`` and
    under ``fsdp`` on this rank's rows; then ``ssl_resume``'s step under
    each strategy, its checkpoint (``save_checkpoint``) resumed under the
    other (``load_checkpoint``: the state and the optimizer's state), and a
    second step there. Rank 0 writes the metrics, the whole gradients and
    the state after each to ``case_dir/ssl_results.pt``."""
    from pathlib import Path

    from pmv_tpu_torch.engine import ssl_steps
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.parallel import distributed
    from pmv_tpu_torch.utils import checkpoint as cu

    case_dir = Path(case_dir)
    cases = torch.load(case_dir / "ssl_cases.pt", weights_only=False)
    resume = cases.pop("ssl_resume")
    out = {}
    for name, case in cases.items():
        for strategy in ("dp", "fsdp"):
            out[name, strategy], _ = _rank_ssl_step(rank, world, name, case, strategy)

    cfg = resume["cfg"].clone()
    first, second = {}, {}
    for strategy, other in (("dp", "fsdp"), ("fsdp", "dp")):
        cfg.OUTPUT_DIR = str(case_dir / f"ssl_{strategy}")
        _, state = _rank_ssl_step(rank, world, "moco", resume, strategy)
        cu.save_checkpoint(cfg.OUTPUT_DIR, state, 0, cfg)
        model = build_model(cfg, device="cpu", dtype=torch.float32)
        resumed = ssl_steps.init_ssl_state(cfg, model, wrapped=distributed.wrap_model(
            model, other, torch.device("cpu")))
        path = cu.get_last_checkpoint(cfg.OUTPUT_DIR, cfg.TASK)
        assert cu.load_checkpoint(path, resumed) == 0
        opt_state = cu.full_state(resumed)[1]
        opt_state["state"] = {i: {k: v.clone() for k, v in st.items()}
                              for i, st in opt_state["state"].items()}
        first[strategy] = whole_state(model), opt_state
        ssl_steps.make_ssl_train_step(cfg, device="cpu")(
            resumed, local_rows(resume["batch2"], rank, world), resume["lr"])
        second[strategy] = whole_state(model)
    out["ssl_resume"] = {
        "first": first, "second": second,
        "files": {s: sorted(p.name for p in (case_dir / f"ssl_{s}" / "checkpoints").iterdir())
                  for s in ("dp", "fsdp")},
        "written": {s: torch.load(cu.get_last_checkpoint(str(case_dir / f"ssl_{s}"), cfg.TASK),
                                  weights_only=True)["model_state"] for s in ("dp", "fsdp")}}
    if rank == 0:
        torch.save(out, case_dir / "ssl_results.pt")


class ClipDataset:
    """Clips in memory: clip i is view i % num_clips of video i // num_clips."""

    def __init__(self, frames, labels, num_clips):
        self.frames, self.labels, self.num_clips = frames, labels, num_clips

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return {"frames": self.frames[i], "label": int(self.labels[i // self.num_clips]),
                "index": i, "time": 0.0, "pm": False}
