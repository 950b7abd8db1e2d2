"""X3D-M's float32 gradients against float64 ones and the JAX package's, and
the train-step limits that chip_smoke.py holds the card to.

Full-width, full-depth X3D-M (configs/Kinetics/X3D_M.yaml) at a small
input ([2, 4, 64, 64, 3], no head dropout), the JAX init in both packages,
on the CPU. A ReLU whose input lies within a rounding of 0 decides either
way, and that one element moves X3D-M's whole gradient, so two sound
float32 runs can lie far apart (``tools/grad_witness.py``):

- with every ReLU of the port's float32 run taking the float64 run's
  decisions (``grad_witness.relu_decisions``), its gradients agree with the
  float64 ones to 1e-4 (relative L2) and its grad norm to rtol 1e-4: apart
  from the ReLUs, what is left is float32 rounding;
- deciding on their own, the port's float32 gradients and the JAX
  package's lie within ``grad_witness.RELU_LIMITS["X3D"]`` (relative L2) of
  the float64 ones (the sound readings); their grad norms are printed, not
  held: the JAX package's own moves by up to 5.5e-3 on a seed, as far as
  some faults move it;
- a fault in K1's taps, in the channel pad's slice, in dx's weight flip or
  in BatchNorm's eps moves the float32 gradients by more than that limit.

Run with ``-s`` to print the readings.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.models import build_model as jax_build_model
from pmv_tpu_torch.models import build_model, common
from pmv_tpu_torch.models.batchnorm import BatchNorm
from pmv_tpu_torch.ops import depthwise as dw
from pmv_tpu_torch.tools.grad_witness import RELU_LIMITS, distance, norm, relu_decisions
from pmv_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax
from torch_port_util import numpy_tree, port_cfg

X3D_M = str(Path(__file__).resolve().parents[1] / "configs" / "Kinetics" / "X3D_M.yaml")
GRAD_LIMIT = RELU_LIMITS["X3D"]


@functools.lru_cache(maxsize=None)
def _cfg():
    cfg = jax_get_cfg()
    cfg.merge_from_file(X3D_M)
    cfg.merge_from_list(["DATA.NUM_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "64",
                         "MODEL.DROPOUT_RATE", "0.0"])
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_model():
    return jax_build_model(_cfg(), dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _jax_grad_fn():
    jmodel = _jax_model()

    def loss(params, batch_stats, x, labels):
        out, _ = jmodel.apply({"params": params, "batch_stats": batch_stats}, x, train=True,
                              mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(out, labels).mean()

    return jax.jit(jax.grad(loss))


@functools.lru_cache(maxsize=None)
def _case(seed):
    """(input, labels, JAX variables as numpy, JAX float32 gradients by port
    name) of ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 4, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 400, 2)
    variables = _jax_model().init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    grads = _jax_grad_fn()(variables["params"], variables["batch_stats"], jnp.asarray(x),
                           jnp.asarray(labels))
    jgrads = state_dict_from_jax(numpy_tree(grads))
    return x, labels, numpy_tree(variables), {k: v.double() for k, v in jgrads.items()}


def _port_grads(seed, dtype, decisions=None):
    """The port's gradients ({name: float64}), grad norm and the ReLU
    decisions of one train-mode step on ``seed``'s case in ``dtype``."""
    x, labels, variables, _ = _case(seed)
    model = build_model(port_cfg(_cfg()), device="cpu", dtype=dtype)
    load_jax_params(model, variables)
    model.train()
    with relu_decisions(decisions) as record:
        out = model(torch.from_numpy(x))
    F.cross_entropy(out, torch.from_numpy(labels)).backward()
    grads = {k: p.grad.double() for k, p in model.named_parameters()}
    return grads, record


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_float32_gradients_against_float64_and_jax(seed):
    *_, jgrads = _case(seed)
    ref, ref_decisions = _port_grads(seed, torch.float64)
    own, _ = _port_grads(seed, torch.float32)
    held, held_record = _port_grads(seed, torch.float32, ref_decisions)
    readings = {
        "port_f32": (distance(own, ref), norm(own) / norm(ref) - 1),
        "jax_f32": (distance(jgrads, ref), norm(jgrads) / norm(ref) - 1),
        "port_f32_f64_decisions": (distance(held, ref), norm(held) / norm(ref) - 1),
    }
    print(f"seed {seed}: (gradients' relative L2, grad norm's relative error) against "
          f"float64: {readings}; ReLU elements {sum(m.numel() for m in ref_decisions.masks)}, "
          f"decided otherwise in float32 {held_record.taken_otherwise}")
    assert set(jgrads) == set(ref)
    grad_err, norm_err = readings["port_f32_f64_decisions"]
    assert grad_err < 1e-4 and abs(norm_err) < 1e-4
    for name in ("port_f32", "jax_f32"):
        assert readings[name][0] < GRAD_LIMIT, name


class _DxUnflipped(torch.autograd.Function):
    """The depthwise conv with dx computed without the weight flip."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return dw.depthwise3x3x3_plain(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return dw.depthwise3x3x3_plain(g, w), dw.depthwise3x3x3_wgrad_plain(x, g)


def _centre_tap_dropped(x, w):
    return dw.depthwise3x3x3(x, w * (torch.arange(27).reshape(3, 3, 3, 1) != 13))


FAULTS = {
    "k1_taps_dt_dw_swapped": lambda x, w: dw.depthwise3x3x3(x, w.permute(2, 1, 0, 3).contiguous()),
    "k1_centre_tap_dropped": _centre_tap_dropped,
    "pad_sliced_off_by_2": lambda x, w: dw.depthwise3x3x3(
        F.pad(x, (0, 2)), F.pad(w, (0, 2)))[..., 2:],
    "dx_unflipped": _DxUnflipped.apply,
    "batchnorm_eps_1e-3": None,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_moves_the_gradients_past_the_limit(fault, monkeypatch):
    sound, _ = _port_grads(0, torch.float32)
    if FAULTS[fault] is None:
        monkeypatch.setattr(BatchNorm, "__init__", functools.partialmethod(
            BatchNorm.__init__, eps=1e-3))
    else:
        monkeypatch.setattr(common, "depthwise3x3x3", FAULTS[fault])
    faulty, _ = _port_grads(0, torch.float32)
    grad_err, norm_err = distance(faulty, sound), norm(faulty) / norm(sound) - 1
    print(f"{fault}: gradients' relative L2 {grad_err}, grad norm's relative error {norm_err}")
    assert grad_err > GRAD_LIMIT
