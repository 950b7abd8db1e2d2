"""MViT config variants of the port against the JAX package's MViT.

Positional embeddings (absolute, separable, fixed sin-cos), mean pooling,
no cls token with a stem norm and layer scale, the 2-D patch stem, and a
portrait clip fed to a landscape-built model (rel-pos tables and the
absolute embedding resized to the runtime grid). Tiny widths, float32 on
the CPU, random numpy weights; atol 2e-4, rtol 1e-4 on the class scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _mvitv2_s_cfg
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.utils.weights import load_jax_params
from torch_port_util import port_cfg, random_params, to_np

VARIANTS = {
    "abs_pos": {"MVIT.USE_ABS_POS": True},
    "sep_pos_embed": {"MVIT.USE_ABS_POS": True, "MVIT.SEP_POS_EMBED": True},
    "sincos_mean_pool": {
        "MVIT.USE_FIXED_SINCOS_POS": True, "MVIT.USE_MEAN_POOLING": True,
    },
    "no_cls_norm_stem_layer_scale": {
        "MVIT.CLS_EMBED_ON": False, "MVIT.NORM_STEM": True,
        "MVIT.LAYER_SCALE_INIT_VALUE": 0.1,
    },
    "patch_2d": {
        "MVIT.PATCH_2D": True, "MVIT.PATCH_KERNEL": [7, 7],
        "MVIT.PATCH_STRIDE": [4, 4], "MVIT.PATCH_PADDING": [3, 3],
    },
    "abs_pos_portrait_input": {
        "MVIT.USE_ABS_POS": True, "DATA.TEST_CROP_SIZE_RECT": [16, 24],
    },
}


def _cfg(overrides):
    cfg = _mvitv2_s_cfg(tiny=True)
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.EMBED_DIM = 16
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.TEST.PROCESS = True
    for key, value in overrides.items():
        section, name = key.split(".")
        cfg[section][name] = value
    return cfg


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mvit_variant_matches_jax(variant):
    cfg = _cfg(VARIANTS[variant])
    t = cfg.DATA.NUM_FRAMES
    h, w = cfg.DATA.TEST_CROP_SIZE_RECT or (16, 16)
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    params = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, t, h, w, 3)), train=False)
    )["params"]
    params = random_params(params, seed=1)
    if variant == "abs_pos_portrait_input":
        h, w = w, h  # a portrait clip into the landscape-built model
    x = np.random.default_rng(2).normal(size=(2, t, h, w, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, train=False))(
        params, jnp.asarray(x)
    )

    model = build_model(port_cfg(cfg), device="cpu", dtype=torch.float32)
    load_jax_params(model, params)
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=2e-4, rtol=1e-4)
