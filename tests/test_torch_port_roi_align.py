"""The port's RoIAlign (``pmv_tpu_torch/ops/roi_align.py``) against the JAX
package's (``pmv_tpu/ops/roi_align.py``) on the CPU: the forward and the
gradient of the features, at atol 1e-5, on a map of 2 batch rows, for boxes
inside the map, boxes past its edges (their samples clamped: bins of equal
value), a box of zero size, and box indices into both rows; aligned and
not. The RoI head's max over the bins where a flat region makes bins of
different positions tie, which ``max`` over a dim would get wrong."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.models.heads import ResNetRoIHead as JaxRoIHead
from pmv_tpu.ops.roi_align import roi_align as jax_roi_align
from pmv_tpu_torch.models.heads import ResNetRoIHead
from pmv_tpu_torch.ops.roi_align import roi_align

TOL = dict(atol=1e-5, rtol=1e-5)
# (x1, y1, x2, y2) in input pixels at spatial_scale 1/4 on an 8 x 10 map (32 x 40 px).
BOXES = np.array([
    [4.0, 6.0, 20.0, 26.0],     # inside
    [0.0, 0.0, 39.0, 31.0],     # the whole frame
    [30.0, 20.0, 60.0, 50.0],   # past the bottom-right edge: clamped samples
    [-12.0, -8.0, 6.0, 4.0],    # past the top-left edge
    [10.0, 10.0, 10.0, 10.0],   # zero size
    [7.3, 2.1, 33.9, 17.7],     # fractional
    [38.0, 4.0, 39.0, 20.0],    # a sliver at the right edge: its bins along x tie
    [50.0, 40.0, 70.0, 60.0],   # wholly outside: every bin is the corner's value
], np.float32)
BATCH_IDX = np.array([0, 1, 1, 0, 1, 0, 1, 0], np.int32)


def _features(seed=0):
    return np.random.default_rng(seed).normal(size=(2, 8, 10, 6)).astype(np.float32)


@pytest.mark.parametrize("aligned", [True, False])
def test_forward_and_gradient_match_jax(aligned):
    feats = _features()
    cot = np.random.default_rng(1).normal(size=(8, 3, 3, 6)).astype(np.float32)

    def jax_fn(f):
        return jax_roi_align(f, jnp.asarray(BOXES), jnp.asarray(BATCH_IDX), (3, 3),
                             spatial_scale=0.25, aligned=aligned)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(feats))
    (want_grad,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(feats).requires_grad_()
    got = roi_align(x, torch.from_numpy(BOXES), torch.from_numpy(BATCH_IDX), (3, 3),
                    spatial_scale=0.25, aligned=aligned)
    got.backward(torch.from_numpy(cot))
    assert got.shape == (8, 3, 3, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **TOL)
    # Row 1's boxes read row 1 only: its gradient lands there.
    assert x.grad[0].abs().sum() > 0 and x.grad[1].abs().sum() > 0


def test_bfloat16_features_give_float32_and_float64_stays():
    feats = torch.from_numpy(_features())
    boxes, idx = torch.from_numpy(BOXES), torch.from_numpy(BATCH_IDX)
    assert roi_align(feats.bfloat16(), boxes, idx, (2, 2), 0.25).dtype == torch.float32
    assert roi_align(feats.double(), boxes, idx, (2, 2), 0.25).dtype == torch.float64


def test_roi_head_max_over_tied_bins_matches_jax():
    """The head's temporal mean, RoIAlign, the max over the bins, the
    projection and the mask, eval and its gradient in train mode. Where
    bins of different positions tie for the max (a flat region), JAX's max
    shares the gradient evenly among them, as ``torch.amax`` does (``max``
    over a dim sends it to one). Ties of clamped samples read one position,
    so their split does not show in the features' gradient."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 8, 10, 6)).astype(np.float32)
    x[0, :, :, :6, 0] = 5.0  # channel 0 flat under the first box: its 9 bins tie
    x = [jnp.asarray(x)]
    boxes = BOXES.reshape(2, 4, 4)
    mask = np.array([[True, True, False, True], [True, True, True, True]])
    jhead = JaxRoIHead(num_classes=5, resolution=3, spatial_scale_factor=4)
    variables = jhead.init(jax.random.PRNGKey(0), x, boxes, mask, train=False)
    variables = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), variables)
    head = ResNetRoIHead([6], 5, resolution=3, spatial_scale_factor=4)
    head.projection.weight.data = torch.from_numpy(np.asarray(variables["params"]["projection"]
                                                              ["kernel"]).T.copy())
    head.projection.bias.data = torch.from_numpy(np.asarray(variables["params"]["projection"]
                                                            ["bias"]).copy())
    want = jhead.apply(variables, x, boxes, mask, train=False)
    got = head.eval()([torch.from_numpy(np.asarray(x[0]))], torch.from_numpy(boxes),
                      torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert float(got[0, 2].detach().abs().max()) == 0.0

    def jloss(inp):
        return jnp.sum(jhead.apply(variables, [inp], boxes, mask, train=True) ** 2)

    want_grad = jax.grad(jloss)(x[0])
    xt = torch.from_numpy(np.array(x[0])).requires_grad_()
    (head.train()([xt], torch.from_numpy(boxes), torch.from_numpy(mask)) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), **TOL)
