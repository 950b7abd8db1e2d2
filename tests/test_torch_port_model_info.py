"""What ``log_model_info`` counts, and the PyTorchVideo model names, against
the JAX package.

- FLOPs and activations of one clip's eval forward on tiny MViT and tiny
  X3D (``utils/misc.py::model_stats``, counted on the meta device):
  - the activations equal JAX's ``activations_count`` of the eval step (the
    outputs of every ``dot_general`` and ``conv_general_dilated`` of its
    jaxpr), exactly: no op differs;
  - the FLOPs equal 2 x the MACs of those same jaxpr ops, exactly (JAX's
    stem unfolded: TPU.FOLD_STEM's folded kernel holds zero taps; the one
    op of difference, MViT's QK^T with the rel-pos tables folded into its
    contraction, counted at q's width: ``_matmul_conv_flops``), and within
    10% of JAX's ``flops_count``, XLA's cost model, which also counts the
    elementwise work and counts some convs its own way (1.08 and 0.95 of it
    on MViT and X3D here).
- ``log_model_info`` logs "Flops: %.2f G / clip" and "Activations: %.2f M /
  clip" as the JAX package does, and a warning for AVSlowFast, whose
  forward needs the audio (JAX's count fails there too).
- PTVResNet, PTVSlowFast, PTVX3D, PTVMViT and PTVR3D build the native model
  of their name (PTVR3D: R(2+1)D, as in the JAX package), with the JAX
  model's parameter count on the tiny yamls.
"""

import contextlib
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _mvitv2_s_cfg
from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.engine import steps as jsteps
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu.utils import misc as jmisc
from pmv_tpu_torch.models import MODEL_REGISTRY
from pmv_tpu_torch.models.mvit import geometry
from pmv_tpu_torch.utils import misc
from torch_port_util import port_cfg

ROOT = Path(__file__).resolve().parents[1]


def _mvit_cfg():
    cfg = _mvitv2_s_cfg(tiny=True)
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]  # block 0's stride-1 pool: K1's conv
    return cfg


def _yaml_cfg(name, *opts):
    cfg = jax_get_cfg()
    cfg.merge_from_file(str(ROOT / "configs" / name))
    cfg.merge_from_list(list(opts))
    return cfg


def _matmul_conv_flops(jaxpr):
    """2 x the MACs of every ``dot_general`` and ``conv_general_dilated`` of
    ``jaxpr`` and its sub-jaxprs. The one op of difference: JAX's MViT folds
    the rel-pos bias into QK^T, [q | tables] against [k | expansion] (its
    "rel-pos expansion matrix", a TPU layout), where the port adds the bias
    to QK^T; a dot whose operand is such a concatenation counts the
    contraction over its first part, q's head width."""
    total = 0
    made_by = {v: eqn for eqn in jaxpr.eqns for v in eqn.outvars}
    for eqn in jaxpr.eqns:
        out = int(np.prod(eqn.outvars[0].aval.shape))
        if eqn.primitive.name == "dot_general":
            (contract, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0]
            sizes = [lhs.aval.shape[d] for d in contract]
            cat = made_by.get(lhs)
            if (cat is not None and cat.primitive.name == "concatenate"
                    and cat.params["dimension"] in contract):
                axis = cat.params["dimension"]
                sizes[contract.index(axis)] = cat.invars[0].aval.shape[axis]
            total += 2 * out * int(np.prod(sizes))
        elif eqn.primitive.name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            spec = eqn.params["dimension_numbers"].rhs_spec  # (out, in, spatial...)
            total += 2 * out * int(np.prod([rhs[d] for d in spec[1:]]))
        for value in eqn.params.values():
            for item in value if isinstance(value, (list, tuple)) else [value]:
                inner = getattr(item, "jaxpr", None)
                if inner is not None:
                    total += _matmul_conv_flops(inner)
                elif hasattr(item, "eqns"):
                    total += _matmul_conv_flops(item)
    return total


@pytest.mark.parametrize("name", ["mvit", "x3d"])
def test_counts_match_jax(name):
    cfg = _mvit_cfg() if name == "mvit" else _yaml_cfg("tiny_x3d_synthetic.yaml")
    # TPU.FOLD_STEM folds the stem conv's stride into its channels, a TPU
    # layout whose kernel holds zero taps: the one op whose MACs would
    # differ (its outputs, the activations, do not).
    cfg.TPU.FOLD_STEM = False
    t, h, w = geometry(port_cfg(cfg))
    frames = np.zeros((2, t, h, w, 3), np.uint8)
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    state, _ = jsteps.init_state(cfg, jmodel, {"frames": jnp.asarray(frames),
                                               "labels": jnp.zeros((2,), jnp.int32)},
                                 jax.random.PRNGKey(0))
    example = {"frames": frames}
    activations = jmisc.eval_activations_per_clip(state, cfg, jmodel, example)
    xla_flops = jmisc.eval_flops_per_clip(state, cfg, jmodel, example)
    eval_step = jsteps.make_eval_step(cfg, jmodel)
    jaxpr = jax.make_jaxpr(eval_step)(state, jnp.asarray(frames)).jaxpr
    flops, acts = misc.model_stats(port_cfg(cfg), [t, h, w, 3])
    assert acts == activations > 0
    assert flops == _matmul_conv_flops(jaxpr) // 2 > 0
    assert abs(flops / xla_flops - 1) < 0.1


@contextlib.contextmanager
def _logged(caplog):
    """caplog's handler on ``misc``'s logger at INFO: the package's logger
    stops propagating once a job has set it up (``setup_logging``)."""
    level = misc.logger.level
    misc.logger.addHandler(caplog.handler)
    misc.logger.setLevel(logging.INFO)
    try:
        yield
    finally:
        misc.logger.removeHandler(caplog.handler)
        misc.logger.setLevel(level)


def test_log_model_info_logs_the_counts(caplog):
    cfg = port_cfg(_mvit_cfg())
    model = MODEL_REGISTRY.get("MViT")(cfg)
    flops, acts = misc.model_stats(cfg, [*geometry(cfg), 3])
    with _logged(caplog):
        misc.log_model_info(model, cfg)
    assert f"Flops: {flops / 1e9:.2f} G / clip" in caplog.text
    assert f"Activations: {acts / 1e6:.2f} M / clip" in caplog.text
    caplog.clear()
    av = port_cfg(_yaml_cfg("Kinetics/AVSLOWFAST_8x8_R50.yaml", "RESNET.DEPTH", 18,
                            "DATA.NUM_FRAMES", 8, "DATA.TRAIN_CROP_SIZE", 16))
    with _logged(caplog):
        misc.log_model_info(model, av)
    assert "Flops and activations not counted" in caplog.text and "Flops:" not in caplog.text


PTV = {  # name -> (the native name, its tiny yaml and opts)
    "PTVResNet": ("ResNet", "Kinetics/SLOW_8x8_R50.yaml",
                  ("RESNET.DEPTH", 18, "RESNET.WIDTH_PER_GROUP", 4, "DATA.NUM_FRAMES", 4,
                   "DATA.TRAIN_CROP_SIZE", 16)),
    "PTVSlowFast": ("SlowFast", "tiny_slowfast_synthetic.yaml", ()),
    "PTVX3D": ("X3D", "tiny_x3d_synthetic.yaml", ()),
    "PTVMViT": ("MViT", "tiny_synthetic.yaml", ()),
    "PTVR3D": ("R2Plus1D", "Kinetics/R2PLUS1D_16x4_R50.yaml",
               ("RESNET.DEPTH", 18, "RESNET.WIDTH_PER_GROUP", 4, "DATA.NUM_FRAMES", 4,
                "DATA.TRAIN_CROP_SIZE", 16)),
}


@pytest.mark.parametrize("name", sorted(PTV))
def test_ptv_names_build_the_native_models(name):
    native, yaml, opts = PTV[name]
    cfg = _yaml_cfg(yaml, "MODEL.MODEL_NAME", name, *opts)
    model = MODEL_REGISTRY.get(name)(port_cfg(cfg))
    assert type(model) is type(MODEL_REGISTRY.get(native)(port_cfg(cfg)))
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    x = jnp.zeros((1, *geometry(port_cfg(cfg)), 3))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jsteps.pack_pathways(cfg, x)[0]
        if cfg.MODEL.ARCH in cfg.MODEL.SINGLE_PATHWAY_ARCH else jsteps.pack_pathways(cfg, x),
        train=False))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == want > 0
