"""The port's MaskFeat model (``models/masked.py``) and masks
(``data/masking.py``) against the JAX package's, on the CPU in float32.

- ``MaskingGenerator``, ``MaskingGenerator3D`` and ``gen_mask`` (tube,
  frames and 3-D branches) on one numpy seed: equal masks and generator
  states after.
- ``hog_targets`` with the JAX package's orientation bins held (a bin is a
  decision, like a ReLU: the count of pixels binned otherwise is printed),
  and an angle of pi (gy = 0, gx < 0; also gy = -0) in bin 0 on both sides.
- The nearest up-sampling against ``jax.image.resize(..., "nearest")`` at
  integer and other ratios (9 -> 5 -> 9), where ``F.interpolate`` differs.
- MaskMViT's forward, from the JAX parameters (``load_state_dict(strict=
  True)``) and one shared mask: HOG targets; pixel targets with a decoder
  with one and with separate position tables; a crop of 36 (a 9 x 9 patch
  grid pooled to 5 x 5 and up-sampled back). pred and target to atol 2e-4,
  rtol 1e-4.
- ``masked_loss``, ``patchify_pixels`` / ``unpatchify_pixels`` and
  ``mae_visualize``: equal to JAX's.
- ``sample_mask``: exactly int(n_tok * ratio) tokens a row, every token
  equally likely.
- A mask window that is not the patch grid raises on both sides, in the port
  with both sizes named.
- Full-width MaskMViT of the PT yaml: names, shapes and the parameter count
  of the JAX tree from ``jax.eval_shape`` (nothing run at full size); its
  stride-1 pools are ``ops.depthwise.MASKFEAT_POOL_SHAPES``, which the
  kernels' launch plans take and the timings of chip_smoke.py cover.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.config.cfg_node import freeze_cfg
from pmv_tpu.data import masking as jmasking
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.models import masked as jmasked
from pmv_tpu_torch.data import masking
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.models import masked
from pmv_tpu_torch.utils.weights import flax_path_to_torch, state_dict_from_jax
from torch_port_util import depthwise_calls, one_thread  # noqa: F401
from torch_port_util import jax_hog_bins, port_cfg, random_params, to_np
from torch_port_util import tiny_maskfeat_cfg as tiny_cfg

ROOT = Path(__file__).resolve().parents[1]
PT_YAML = ROOT / "configs" / "masked_ssl" / "k400_MVITv2_S_16x4_MaskFeat_PT.yaml"
MASKFEAT_PARAMS = 36_190_974  # full-width MaskMViT of the PT yaml, both packages
ATOL, RTOL = 2e-4, 1e-4
pytestmark = pytest.mark.usefixtures("one_thread")


def jax_params(cfg, seed):
    """The JAX model and its parameters, every one drawn with numpy on the
    shapes of its init (``jax.eval_shape``)."""
    jmodel = jmasked.MaskMViT(cfg=freeze_cfg(cfg.clone()), dtype=jnp.float32)
    crop = cfg.DATA.TRAIN_CROP_SIZE
    x = jax.ShapeDtypeStruct((1, cfg.DATA.NUM_FRAMES, crop, crop, 3), jnp.float32)
    shapes = jax.eval_shape(lambda x: jmodel.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, x, train=False), x)
    return jmodel, random_params(shapes["params"], seed)


def jax_apply(jmodel, params, x, mask):
    """(pred, target, mask) of the JAX model in eval mode, jitted."""
    return jax.jit(lambda p, x, m: jmodel.apply({"params": p}, x, mask=m, train=False))(
        params, jnp.asarray(x), jnp.asarray(mask))


def test_masking_generators_match_jax():
    for seed in range(3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(
            masking.MaskingGenerator((14, 14), 60, min_num_patches=12, rng=a)(),
            jmasking.MaskingGenerator((14, 14), 60, min_num_patches=12, rng=b)())
        np.testing.assert_array_equal(
            masking.MaskingGenerator3D((8, 7, 7), 157, min_num_patches=9, max_num_patches=49,
                                       rng=a)(),
            jmasking.MaskingGenerator3D((8, 7, 7), 157, min_num_patches=9, max_num_patches=49,
                                        rng=b)())
        assert a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("branch", ["blocks_3d", "tube", "frames"])
def test_gen_mask_matches_jax(branch):
    cfg = jax_get_cfg()
    cfg.AUG.MASK_WINDOW_SIZE = [8, 7, 7]
    cfg.AUG.MASK_RATIO = 0.4
    cfg.AUG.MASK_TUBE = branch == "tube"
    cfg.AUG.MASK_FRAMES = branch == "frames"
    pcfg = port_cfg(cfg)
    for seed in range(4):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = masking.gen_mask(pcfg, a), jmasking.gen_mask(cfg, b)
        assert got.shape == (8, 7, 7) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert a.bit_generator.state == b.bit_generator.state


def test_hog_targets_match_jax_with_its_bins_held():
    frames = np.random.default_rng(0).normal(size=(2, 4, 32, 24, 3)).astype(np.float32)
    want = np.asarray(jmasked.hog_targets(jnp.asarray(frames), nbins=9, cell_sz=8))
    bins = jax_hog_bins(jnp.asarray(frames))
    x = torch.from_numpy(frames)
    otherwise = int((masked.hog_bins(x).numpy() != bins).sum())
    print(f"pixels binned otherwise than JAX: {otherwise} of {bins.size}")
    got = masked.hog_targets(x, nbins=9, cell_sz=8, bins=torch.tensor(bins).long())
    assert got.shape == want.shape == (2, 4, 4, 3, 27)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert otherwise <= 1e-4 * bins.size


def test_an_angle_of_pi_lands_in_bin_0_on_both_sides():
    """gy = 0 and gx < 0 (atan2 gives pi; with gy = -0, -pi): bin 0."""
    ramp = 3.0 - np.arange(8, dtype=np.float32)  # gx = -2 inside, gy = 0
    frames = np.broadcast_to(ramp[None, None, None, :, None], (1, 1, 8, 8, 3)).copy()
    signed = frames.copy()
    signed[:, :, 2::4, 3] = signed[:, :, 3::4, 3] = -0.0  # gy = -0 - 0 in rows 1 and 5
    for f in (frames, signed):
        want = jax_hog_bins(jnp.asarray(f))
        got = masked.hog_bins(torch.from_numpy(f)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got == 0).all()


@pytest.mark.parametrize("size_in,size_out", [(14, 56), (5, 9), (9, 5), (3, 7)])
def test_nearest_resize_matches_jax_image_resize(size_in, size_out):
    grid = np.random.default_rng(0).normal(size=(1, 2, size_in, size_in, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(grid), (1, 2, size_out, size_out, 3),
                                       method="nearest"))
    got = masked.resize_nearest(torch.from_numpy(grid), (2, size_out, size_out))
    np.testing.assert_array_equal(got.numpy(), want)
    torch_nearest = F.interpolate(torch.from_numpy(grid).permute(0, 4, 1, 2, 3),
                                  size=(2, size_out, size_out), mode="nearest")
    differs = not np.array_equal(torch_nearest.permute(0, 2, 3, 4, 1).numpy(), want)
    assert differs == (size_out % size_in != 0)


FORWARD_CASES = {
    "hog": dict(),
    "pixels_decoder": dict(pred_hog=False, decoder_depth=1),
    # A 9 x 9 patch grid pooled to 5 x 5 and up-sampled back.
    "pixels_decoder_sep_pos_crop36": dict(crop=36, pred_hog=False, decoder_depth=2,
                                          sep_pos=True),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_matches_jax(case):
    cfg = tiny_cfg(**FORWARD_CASES[case])
    crop = cfg.DATA.TRAIN_CROP_SIZE
    jmodel, params = jax_params(cfg, 1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, crop, crop, 3)).astype(np.float32)
    n_tok = 2 * (crop // 4) ** 2
    mask = rng.uniform(size=(2, n_tok)) < 0.4
    jpred, jtarget, jmask = jax_apply(jmodel, params, x, mask)
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.eval()
    held = jax_hog_bins(jnp.asarray(x)) if cfg.MASK.PRED_HOG else None
    with torch.no_grad():
        pred, target, got_mask = model(torch.from_numpy(x), torch.from_numpy(mask),
                                       hog_bins=None if held is None else torch.tensor(held))
    assert pred.shape == jpred.shape and target.shape == jtarget.shape
    np.testing.assert_allclose(target.numpy(), np.asarray(jtarget), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(jmask))
    loss = masked.masked_loss(pred, target, got_mask)
    jloss = jmasked.masked_loss(jpred, jtarget, jmask)
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=RTOL)
    if cfg.MASK.DECODER_DEPTH:
        assert "decoder_blocks.0" in params and any(
            k.startswith("decoder_blocks.0.") for k in model.state_dict())


def test_patchify_round_trip_and_mae_visualize_match_jax():
    cfg = tiny_cfg(pred_hog=False)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (2, 4, 32, 32, 3)).astype(np.float32)
    patches, geom = masked.patchify_pixels((2, 4, 4), True, torch.from_numpy(x))
    jpatches, jgeom = jmasked.patchify_pixels(cfg, jnp.asarray(x))
    assert geom == jgeom
    np.testing.assert_array_equal(patches.numpy(), np.asarray(jpatches))
    np.testing.assert_array_equal(masked.unpatchify_pixels(patches, geom).numpy(), x[:, ::2])
    pred = rng.normal(size=patches.shape).astype(np.float32)
    mask = rng.uniform(size=patches.shape[:2]) < 0.5
    for norm in (False, True):
        cfg.MASK.NORM_PRED_PIXEL = norm
        got = masked.mae_visualize(port_cfg(cfg), torch.from_numpy(x), torch.from_numpy(pred),
                                   torch.from_numpy(mask))
        want = jmasked.mae_visualize(cfg, jnp.asarray(x), jnp.asarray(pred), jnp.asarray(mask))
        assert got.dtype == torch.uint8 and got.shape == (2, 3, 2, 32, 32, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_mask_masks_k_tokens_a_row_each_token_equally_likely():
    model = build_model(port_cfg(tiny_cfg()), device="cpu", dtype=torch.float32)
    rows = 4000
    mask = model.sample_mask((rows, 4, 32, 32, 3), torch.Generator().manual_seed(0))
    n_tok, k = 2 * 8 * 8, int(2 * 8 * 8 * 0.4)
    assert mask.shape == (rows, n_tok) and mask.dtype == torch.bool
    assert (mask.sum(dim=1) == k).all()
    p = k / n_tok
    z = (mask.sum(dim=0).double() - rows * p) / (rows * p * (1 - p)) ** 0.5
    assert float(z.abs().max()) < 5.0
    again = model.sample_mask((rows, 4, 32, 32, 3), torch.Generator().manual_seed(0))
    assert torch.equal(mask, again)


def test_a_mask_window_other_than_the_patch_grid_raises_on_both_sides():
    """The PT yaml's loader window [8, 7, 7] against its 8 x 56 x 56 patch
    grid, here a window of 2 x 4 x 4 against a 2 x 8 x 8 grid."""
    cfg = tiny_cfg()
    jmodel, params = jax_params(cfg, 1)
    x = np.zeros((2, 4, 32, 32, 3), np.float32)
    mask = np.ones((2, 32), bool)
    with pytest.raises((TypeError, ValueError)):
        jax_apply(jmodel, params, x, mask)
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match=r"32 tokens a clip, the patch grid 2x8x8 = 128"):
        model(torch.from_numpy(x), torch.from_numpy(mask))


def _jax_names_and_shapes(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(k.key) for k in path]
        shape = tuple(leaf.shape)
        if names[-1] in ("kernel", "pool_kernel"):
            shape = {5: lambda s: (s[4], s[3], *s[:3]), 2: lambda s: s[::-1]}[len(shape)](shape)
        out[flax_path_to_torch(names)] = shape
    return out


def test_full_width_pt_model_names_and_count_match_jax():
    cfg = jax_get_cfg()
    cfg.merge_from_file(str(PT_YAML))
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    x = jax.ShapeDtypeStruct((1, 16, 224, 224, 3), jnp.float32)
    shapes = jax.eval_shape(lambda x: jmodel.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, x, train=False), x)
    expected = _jax_names_and_shapes(shapes["params"])
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        model = masked.MaskMViT(port_cfg(cfg))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == expected
    assert sum(p.numel() for p in model.parameters()) == n_jax == MASKFEAT_PARAMS
    assert got["mask_token"] == (1, 1, 3)
    assert got["pred_head.projection.weight"] == (27, 768)
    assert "backbone.norm.weight" not in got and "backbone.head.projection.weight" not in got


def test_backbone_features_are_the_pre_norm_tokens_of_jax_mvit():
    """``MViT.forward(return_features=True)``: the last block's tokens,
    before the final norm, as the JAX MViT returns them."""
    from pmv_tpu.models.mvit import MViT as JMViT

    cfg = tiny_cfg()
    cfg.MODEL.MODEL_NAME = "MViT"
    jmodel = JMViT(cfg=freeze_cfg(cfg.clone()), dtype=jnp.float32)
    x = np.random.default_rng(3).normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False),
                            jax.ShapeDtypeStruct(x.shape, jnp.float32))
    params = random_params(shapes["params"], 4)
    jfeats, jthw = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, train=False,
                                                     return_features=True))(params, jnp.asarray(x))
    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.eval()
    with torch.no_grad():
        feats, thw = model(torch.from_numpy(x), return_features=True)
    assert tuple(thw) == tuple(jthw) == (2, 4, 4)
    np.testing.assert_allclose(to_np(feats), np.asarray(jfeats), atol=ATOL, rtol=RTOL)


def test_pt_pools_are_maskfeat_pool_shapes_planned_and_swept(depthwise_calls):  # noqa: F811
    """The PT yaml's stride-1 3x3x3 pools at batch 8 (from the MViT
    schedule) are ``MASKFEAT_POOL_SHAPES``, 14 a forward, blocks 14-15's at
    8 x 14 x 14; each is a shape of ``MVIT_POOL_SHAPES``, which phase 2 of
    chip_smoke.py and tools/plan_sweep.py run, and both kernels' launch
    plans take it. At a tiny width the forward calls K1's wrapper 14 times."""
    from collections import Counter

    from pmv_tpu_torch.models.mvit import _compute_mvit_schedule
    from pmv_tpu_torch.ops import depthwise as dw

    cfg = jax_get_cfg()
    cfg.merge_from_file(str(PT_YAML))
    pcfg = port_cfg(cfg)
    grid, shapes = [8, 56, 56], []
    for spec in _compute_mvit_schedule(pcfg):
        channels = spec["dim_out"] if pcfg.MVIT.DIM_MUL_IN_ATT else spec["dim"]
        for kind in ("q", "kv", "kv"):
            if spec[f"kernel_{kind}"] == (3, 3, 3) and spec[f"stride_{kind}"] == (1, 1, 1):
                shapes.append((8, *grid, channels))
        grid = [g // s for g, s in zip(grid, spec["stride_q"] or (1, 1, 1))]
    assert Counter(shapes) == Counter({s: n for s, n in dw.MASKFEAT_POOL_SHAPES})
    assert len(shapes) == 14 and shapes[-2:] == [(8, 8, 14, 14, 768)] * 2
    swept = {s for s, _ in dw.MVIT_POOL_SHAPES}
    for shape, _ in dw.MASKFEAT_POOL_SHAPES:
        assert shape in swept
        for elem_size in (2, 4):
            assert dw.plan_forward(shape, elem_size).blocks > 0
            assert dw.plan_wgrad(shape, elem_size).blocks > 0

    pcfg.merge_from_list(["MVIT.EMBED_DIM", "8", "DATA.NUM_FRAMES", "4",
                          "DATA.TRAIN_CROP_SIZE", "32"])
    model = build_model(pcfg, device="cpu", dtype=torch.float32).eval()
    x = torch.zeros(1, 4, 32, 32, 3)
    with torch.no_grad():
        model(x, model.sample_mask(tuple(x.shape), torch.Generator().manual_seed(0)))
    assert len(depthwise_calls) == 14
