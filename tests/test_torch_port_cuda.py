"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs where JAX is not installed; there the repository's
conftest (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from pmv_tpu_torch.engine.steps import make_eval_step
from pmv_tpu_torch.entry import mvitv2_s_cfg
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.ops.depthwise import depthwise3x3x3, depthwise3x3x3_plain
from torch_port_util import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda

# MViTv2-S 16x4 pool shapes at batch 8 (C = heads * head_dim), and an odd
# portrait grid.
SHAPES = [
    (8, 8, 56, 56, 96),
    (8, 8, 28, 28, 192),
    (8, 8, 14, 14, 384),
    (8, 8, 14, 14, 768),
    (8, 8, 7, 7, 768),
    (2, 3, 13, 7, 24),
]


def _inputs(shape, device, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 3, shape[-1])) * 0.1).astype(np.float32))
    return x.to(device, dtype), w.to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(cuda_device, shape, dtype):  # noqa: F811
    x, w = _inputs(shape, cuda_device, dtype)
    before = depthwise3x3x3.launches
    out = depthwise3x3x3(x, w)
    torch.cuda.synchronize()
    assert depthwise3x3x3.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    # The plain version in float32 from the same (rounded) inputs.
    ref = depthwise3x3x3_plain(x.float(), w.float())
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    else:  # one bf16 rounding of the output
        torch.testing.assert_close(out.float(), ref, atol=1e-2, rtol=8e-3)


def test_kernel_refuses_what_it_does_not_take(cuda_device):  # noqa: F811
    x, w = _inputs((1, 2, 4, 4, 16), cuda_device, torch.float32)
    with pytest.raises(RuntimeError, match="forward-only"):
        depthwise3x3x3(x.requires_grad_(), w)
    x = x.detach()
    with pytest.raises(TypeError):
        depthwise3x3x3(x, w.bfloat16())
    with pytest.raises(ValueError, match="multiple of 8"):
        depthwise3x3x3(x[..., :12].contiguous(), w[..., :12].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        depthwise3x3x3(x.transpose(2, 3), w)
    with pytest.raises(ValueError):
        depthwise3x3x3(x, w.cpu())


def test_tiny_model_on_card_matches_cpu(cuda_device):  # noqa: F811
    """The eval step at tiny width with 3x3x3 pools, float32, card vs CPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = mvitv2_s_cfg(tiny=True)
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.EMBED_DIM = 16
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    frames = np.random.default_rng(1).integers(0, 256, (2, 4, 16, 16, 3), np.uint8)
    cpu_model = build_model(cfg, device="cpu", dtype=torch.float32, seed=2)
    gpu_model = build_model(cfg, device=cuda_device, dtype=torch.float32, seed=2)
    before = depthwise3x3x3.launches
    gpu = make_eval_step(cfg, gpu_model, device=cuda_device)(frames).cpu()
    assert depthwise3x3x3.launches - before == 3  # q-pool 0, K and V pools 1
    cpu = make_eval_step(cfg, cpu_model, device="cpu")(frames)
    torch.testing.assert_close(gpu, cpu, atol=2e-5, rtol=0)
