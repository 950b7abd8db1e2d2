"""Every shipped yaml under ``configs/`` builds in the port, with the JAX
model's parameter count (the port's counterpart of tests/test_config_zoo.py):
the Kinetics yamls here, the others in tests/test_torch_port_config_zoo_tasks.py.

Each yaml is one case: the port's model of the yaml, as
``assert_and_infer_cfg`` leaves it, built on the ``meta`` device (shapes
only), against the JAX model of the same yaml at its own sizes, initialised
under ``jax.eval_shape`` (nothing is computed): a clip of the yaml's
frames and train crop (its rect crop where it sets one), packed into
pathways where the arch has two; MaskMViT with its "mask" stream;
AVSlowFast with its log-mel (and the misaligned one where the yaml draws
it); an AVA detection model with one box; the contrastive models through
``init_ssl_state``, whose online encoder, BYOL's predictor and SwAV's
prototypes the port's parameters hold beside it.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.config import assert_and_infer_cfg as jax_infer
from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.engine import ssl_steps as jssl
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu_torch.config import get_cfg
from pmv_tpu_torch.config.defaults import assert_and_infer_cfg
from pmv_tpu_torch.models import MODEL_REGISTRY
from pmv_tpu_torch.models.mvit import geometry

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
# The Kinetics yamls here, the others in tests/test_torch_port_config_zoo_tasks.py:
# two files, which the test run's workers take in parallel.
KINETICS = [p for p in CONFIGS if os.sep + "Kinetics" + os.sep in p]


def _count(tree):
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(tree))


def jax_param_count(cfg):
    """The JAX model's parameters for ``cfg``, from ``jax.eval_shape``."""
    model = jax_build_model(cfg, dtype=jnp.float32)
    t, h, w = geometry(cfg)
    x = jax.ShapeDtypeStruct((1, t, h, w, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    name = cfg.MODEL.MODEL_NAME
    if name == "ContrastiveModel":
        batch = {"frames": jax.ShapeDtypeStruct((2, t, h, w, 3), jnp.uint8),
                 "labels": jax.ShapeDtypeStruct((2,), jnp.int32)}
        state = jax.eval_shape(lambda b: jssl.init_ssl_state(cfg, model, b, key)[0], batch)
        return _count(state.params) + _count(state.predictor_params) + _count(state.prototypes)
    if name == "MaskMViT":
        shapes = jax.eval_shape(lambda x: model.init(
            {"params": key, "mask": jax.random.fold_in(key, 1)}, x, train=False), x)
        return _count(shapes["params"])
    inputs = x
    if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH:
        audio = jax.ShapeDtypeStruct((1, cfg.DATA.AUDIO_FRAME_NUM, cfg.DATA.AUDIO_MEL_NUM),
                                     jnp.float32)
        misaligned = audio if cfg.DATA.GET_MISALIGNED_AUDIO else None
        inputs = jax.eval_shape(lambda x, a, m: jsteps.pack_pathways(cfg, x, a, m), x, audio,
                                misaligned)
    kwargs = {}
    if cfg.DETECTION.ENABLE:
        kwargs = {"boxes": jnp.zeros((1, 1, 4)), "box_mask": jnp.ones((1, 1), bool)}
    shapes = jax.eval_shape(lambda x: model.init(key, x, train=False, **kwargs), inputs)
    return _count(shapes["params"])


def config_ids(paths):
    return [os.path.relpath(p, os.path.join(ROOT, "configs"))[:-5] for p in paths]


def check_parameter_count(path):
    cfg = get_cfg()
    cfg.merge_from_file(path)
    cfg = assert_and_infer_cfg(cfg)
    with torch.device("meta"):
        model = MODEL_REGISTRY.get(cfg.MODEL.MODEL_NAME)(cfg)
    got = sum(p.numel() for p in model.parameters())
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(path)
    jcfg = jax_infer(jcfg)
    assert got == jax_param_count(jcfg) > 0


@pytest.mark.parametrize("path", KINETICS, ids=config_ids(KINETICS))
def test_kinetics_config_builds_with_the_jax_parameter_count(path):
    check_parameter_count(path)
