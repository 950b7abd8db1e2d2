"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs where JAX is not installed; there the repository's
conftest (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pmv_tpu_torch.engine.steps import init_state, make_eval_step, make_train_step
from pmv_tpu_torch.entry import apply_bench_recipe, mvitv2_s_cfg
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.engine.prefetch import DevicePrefetcher
from pmv_tpu_torch.ops.depthwise import (
    MVIT_POOL_SHAPES,
    MVIT_PORTRAIT_POOL_SHAPES,
    MVIT_RECT_POOL_SHAPES,
    MVIT_RECT_TRAIN_POOL_SHAPES,
    ODD_SHAPES,
    PADDED_ODD_SHAPES,
    UNIFORMER_DPE_SHAPES,
    UNIFORMER_PORTRAIT_DPE_SHAPES,
    UNIFORMER_RECT_DPE_SHAPES,
    UNIFORMER_TRAIN_DPE_SHAPES,
    X3D_DW_SHAPES,
    X3D_PORTRAIT_DW_SHAPES,
    X3D_RECT_DW_SHAPES,
    X3D_TEST_DW_SHAPES,
    depthwise3x3x3,
    depthwise3x3x3_plain,
    depthwise3x3x3_wgrad,
    depthwise3x3x3_wgrad_plain,
)
from torch_port_util import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda

# MViTv2-S 16x4 pool shapes at batch 8 (the 224^2 crop, the PMV rect crop
# and its transposes), the PMV rect ones at the run_net train step's batch
# of 16, UniFormer-S 16x4's DPE shapes (the same grids, at batch 8 and 16),
# X3D-M's stride-1 channelwise convs (224^2, rect, transposed and 256^2 at
# batch 8; C = 54 and 108 through the channel pad), and odd shapes the
# kernels' tiling and the pad must take (ops/depthwise.py).
SHAPES = [
    s for s, _ in MVIT_POOL_SHAPES + MVIT_RECT_POOL_SHAPES + MVIT_PORTRAIT_POOL_SHAPES
    + MVIT_RECT_TRAIN_POOL_SHAPES + UNIFORMER_DPE_SHAPES + UNIFORMER_RECT_DPE_SHAPES
    + UNIFORMER_PORTRAIT_DPE_SHAPES + UNIFORMER_TRAIN_DPE_SHAPES + X3D_DW_SHAPES
    + X3D_RECT_DW_SHAPES + X3D_PORTRAIT_DW_SHAPES + X3D_TEST_DW_SHAPES
] + list(ODD_SHAPES) + list(PADDED_ODD_SHAPES)


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
    """What the kernels do not take raises; a gradient is computed, through
    K1 (dx) and the wgrad kernel (dw), against the plain versions; a C that
    is not a multiple of 8 is padded, launches each kernel once and matches
    the plain versions."""
    x, w = _inputs((1, 2, 4, 4, 16), cuda_device, torch.float32)
    g = torch.randn_like(x)
    x.requires_grad_()
    w.requires_grad_()
    k1, wg = depthwise3x3x3.launches, depthwise3x3x3_wgrad.launches
    depthwise3x3x3(x, w).backward(g)
    torch.cuda.synchronize()
    assert depthwise3x3x3.launches == k1 + 2  # forward and dx
    assert depthwise3x3x3_wgrad.launches == wg + 1
    dx, dw = x.grad, w.grad
    x, w = x.detach(), w.detach()
    torch.testing.assert_close(
        dx, depthwise3x3x3_plain(g, w.flip(0, 1, 2)), atol=1e-5, rtol=1e-5
    )
    torch.testing.assert_close(dw, depthwise3x3x3_wgrad_plain(x, g), atol=1e-4, rtol=1e-5)
    with pytest.raises(TypeError):
        depthwise3x3x3(x, w.bfloat16())
    x12, w12, g12 = (t[..., :12].contiguous() for t in (x, w, g))
    k1, wg = depthwise3x3x3.launches, depthwise3x3x3_wgrad.launches
    out, dw12 = depthwise3x3x3(x12, w12), depthwise3x3x3_wgrad(x12, g12)
    torch.cuda.synchronize()
    assert (depthwise3x3x3.launches, depthwise3x3x3_wgrad.launches) == (k1 + 1, wg + 1)
    assert out.shape == x12.shape and dw12.shape == (3, 3, 3, 12)
    torch.testing.assert_close(out, depthwise3x3x3_plain(x12, w12), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dw12, depthwise3x3x3_wgrad_plain(x12, g12), atol=1e-4, rtol=1e-5)
    # Through the autograd Function: x, w and g padded once, 2 K1 launches
    # and 1 wgrad, dx and dw sliced back.
    x12.requires_grad_()
    w12.requires_grad_()
    k1, wg = depthwise3x3x3.launches, depthwise3x3x3_wgrad.launches
    depthwise3x3x3(x12, w12).backward(g12)
    torch.cuda.synchronize()
    assert (depthwise3x3x3.launches, depthwise3x3x3_wgrad.launches) == (k1 + 2, wg + 1)
    assert x12.grad.shape == x12.shape and w12.grad.shape == (3, 3, 3, 12)
    torch.testing.assert_close(x12.grad, depthwise3x3x3_plain(g12, w12.detach().flip(0, 1, 2)),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(w12.grad, depthwise3x3x3_wgrad_plain(x12.detach(), g12),
                               atol=1e-4, rtol=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        depthwise3x3x3(x.transpose(2, 3), w)
    with pytest.raises(ValueError):
        depthwise3x3x3(x, w.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        depthwise3x3x3_wgrad(x, g.transpose(2, 3))
    with pytest.raises(TypeError):
        depthwise3x3x3_wgrad(x, g.bfloat16())


# dw sums up to B*T*H*W = 200,704 products of N(0, 1) values, of order
# sqrt(200,704) ~ 450, in another order than the plain version.
WGRAD_TOLERANCE = {
    torch.float32: dict(atol=2e-3, rtol=1e-5),
    torch.bfloat16: dict(atol=1e-2, rtol=8e-3),  # one bf16 rounding of dw
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_wgrad_kernel_matches_plain(cuda_device, shape, dtype):  # noqa: F811
    x, _ = _inputs(shape, cuda_device, dtype)
    g, _ = _inputs(shape, cuda_device, dtype, seed=1)
    before = depthwise3x3x3_wgrad.launches
    dw = depthwise3x3x3_wgrad(x, g)
    torch.cuda.synchronize()
    assert depthwise3x3x3_wgrad.launches == before + 1
    assert dw.dtype == dtype and dw.shape == (3, 3, 3, shape[-1])
    ref = depthwise3x3x3_wgrad_plain(x.float(), g.float())
    torch.testing.assert_close(dw.float(), ref, **WGRAD_TOLERANCE[dtype])
    assert torch.equal(dw, depthwise3x3x3_wgrad(x, g))  # deterministic


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grads_on_card_match_cpu(cuda_device, dtype):  # noqa: F811
    """The autograd Function's dx and dw, card against CPU, from the same
    (rounded) inputs."""
    x, w = _inputs((2, 4, 9, 7, 24), "cpu", dtype)
    g = torch.from_numpy(np.random.default_rng(2).normal(size=x.shape)).to(dtype)
    grads = []
    for device in ("cpu", cuda_device):
        xd = x.detach().to(device).requires_grad_()
        wd = w.detach().to(device).requires_grad_()
        depthwise3x3x3(xd, wd).backward(g.to(device))
        grads.append((xd.grad.cpu().float(), wd.grad.cpu().float()))
    (dx_cpu, dw_cpu), (dx_gpu, dw_gpu) = grads
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-2, rtol=8e-3)
    torch.testing.assert_close(dx_gpu, dx_cpu, **tol)
    torch.testing.assert_close(dw_gpu, dw_cpu, **tol)


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


def test_tiny_train_step_on_card_matches_cpu(cuda_device):  # noqa: F811
    """One train step of the bench recipe at tiny width with 3x3x3 pools,
    float32, card against CPU from the same weights and draws: loss and
    grad norm to rtol 1e-5, gradients to 1e-5 of their norm, and the
    updated weights to 2 lr (a gradient element within float noise of 0,
    as the K-norm bias's, may take AdamW's first step either way)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = apply_bench_recipe(mvitv2_s_cfg(tiny=True))
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    lr = 1e-3
    rng = np.random.default_rng(3)
    batch = {"frames": rng.integers(0, 256, (2, 4, 16, 16, 3), np.uint8),
             "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, 2)}
    models, metrics = [], []
    draws = None
    for device in ("cpu", cuda_device):
        model = build_model(cfg, device=device, dtype=torch.float32, seed=2)
        step = make_train_step(cfg, device=device)
        draws = draws or step.sample_draws(model, batch["frames"].shape)
        k1, wg = depthwise3x3x3.launches, depthwise3x3x3_wgrad.launches
        metrics.append({k: v.cpu() for k, v in step(init_state(cfg, model), batch, lr, draws).items()})
        models.append(model)
    assert depthwise3x3x3.launches - k1 == 6  # 3 pools, forward and dx
    assert depthwise3x3x3_wgrad.launches - wg == 3
    (cpu, gpu), (cpu_model, gpu_model) = metrics, models
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(gpu[key], cpu[key], atol=0, rtol=1e-5)
    for key in ("top1_err", "top5_err", "nan"):
        assert torch.equal(gpu[key], cpu[key])
    grads = [(p.grad, q.grad.cpu()) for p, q in zip(cpu_model.parameters(), gpu_model.parameters())]
    diff = sum(float((a - b).square().sum()) for a, b in grads) ** 0.5
    assert diff <= 1e-5 * float(cpu["grad_norm"])
    for (name, a), b in zip(cpu_model.state_dict().items(), gpu_model.state_dict().values()):
        torch.testing.assert_close(b.cpu(), a, atol=2.0001 * lr, rtol=0, msg=name)


def _tiny_uniformer_cfg():
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parents[1] / "configs" / "Kinetics"
                            / "UNIFORMER_S_16x4.yaml"))
    cfg.UNIFORMER.EMBED_DIM = [8, 16, 16, 32]
    cfg.UNIFORMER.DEPTH = [1, 1, 1, 1]
    cfg.UNIFORMER.HEAD_DIM = 8
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 64
    return cfg


def test_tiny_uniformer_on_card_matches_cpu(cuda_device):  # noqa: F811
    """UniFormer at tiny width, float32, card against CPU: the eval step
    (one DPE a block: 4 K1 launches), then one train step of its config's
    recipe from the same weights and draws (8 K1 and 4 wgrad launches),
    with the BatchNorm running statistics to rtol 1e-4."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _tiny_uniformer_cfg()
    lr = 1e-3
    rng = np.random.default_rng(5)
    batch = {"frames": rng.integers(0, 256, (2, 4, 64, 64, 3), np.uint8),
             "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, 2)}
    models, metrics, scores = [], [], []
    draws = None
    for device in ("cpu", cuda_device):
        model = build_model(cfg, device=device, dtype=torch.float32, seed=2)
        k1 = depthwise3x3x3.launches
        scores.append(make_eval_step(cfg, model, device=device)(batch["frames"]).cpu())
        eval_k1 = depthwise3x3x3.launches - k1
        step = make_train_step(cfg, device=device)
        draws = draws or step.sample_draws(model, batch["frames"].shape)
        k1, wg = depthwise3x3x3.launches, depthwise3x3x3_wgrad.launches
        metrics.append({k: v.cpu() for k, v in step(init_state(cfg, model), batch, lr, draws).items()})
        models.append(model)
    assert eval_k1 == 4
    assert (depthwise3x3x3.launches - k1, depthwise3x3x3_wgrad.launches - wg) == (8, 4)
    torch.testing.assert_close(scores[1], scores[0], atol=2e-5, rtol=0)
    (cpu, gpu), (cpu_model, gpu_model) = metrics, models
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(gpu[key], cpu[key], atol=0, rtol=1e-5)
    for (name, a), b in zip(cpu_model.state_dict().items(), gpu_model.state_dict().values()):
        if "running" in name:
            torch.testing.assert_close(b.cpu(), a, atol=1e-6, rtol=1e-4, msg=name)
        else:
            torch.testing.assert_close(b.cpu(), a, atol=2.0001 * lr, rtol=0, msg=name)


def test_tiny_x3d_on_card_matches_cpu(cuda_device):  # noqa: F811
    """X3D on configs/tiny_x3d_synthetic.yaml at DEPTH_FACTOR 1.0 (7 stride-1
    channelwise convs a forward, C = 24, 48 and 96), float32, card against
    CPU: the eval step (7 K1 launches), one SGD train step with the head's
    dropout from the same weights and draws (14 K1 and 7 wgrad launches),
    and precise BN over 2 batches (14 K1), the BatchNorm running
    statistics to rtol 1e-4."""
    from pmv_tpu_torch.config import get_cfg
    from pmv_tpu_torch.engine.precise_bn import calculate_and_update_precise_bn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parents[1] / "configs"
                            / "tiny_x3d_synthetic.yaml"))
    cfg.merge_from_list(["X3D.DEPTH_FACTOR", "1.0", "TRAIN.MIXED_PRECISION", "False"])
    lr = 0.05
    rng = np.random.default_rng(6)
    batch = {"frames": rng.integers(0, 256, (4, 4, 64, 64, 3), np.uint8),
             "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, 4)}
    loader = [{"frames": rng.integers(0, 256, (4, 4, 64, 64, 3), np.uint8)} for _ in range(2)]
    models, metrics, scores, launches = [], [], [], []
    draws = None
    for device in ("cpu", cuda_device):
        model = build_model(cfg, device=device, dtype=torch.float32, seed=2)
        k1, wg = depthwise3x3x3.launches, depthwise3x3x3_wgrad.launches
        scores.append(make_eval_step(cfg, model, device=device)(batch["frames"]).cpu())
        step = make_train_step(cfg, device=device)
        draws = draws or step.sample_draws(model, batch["frames"].shape)
        state = init_state(cfg, model)
        metrics.append({k: v.cpu() for k, v in step(state, batch, lr, draws).items()})
        calculate_and_update_precise_bn(loader, state, cfg, device)
        launches.append((depthwise3x3x3.launches - k1, depthwise3x3x3_wgrad.launches - wg))
        models.append(model)
    assert launches[1] == (7 + 14 + 14, 7)
    torch.testing.assert_close(scores[1], scores[0], atol=2e-5, rtol=0)
    (cpu, gpu), (cpu_model, gpu_model) = metrics, models
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(gpu[key], cpu[key], atol=0, rtol=1e-5)
    for (name, a), b in zip(cpu_model.state_dict().items(), gpu_model.state_dict().values()):
        if "running" in name:
            torch.testing.assert_close(b.cpu(), a, atol=1e-6, rtol=1e-4, msg=name)
        else:
            torch.testing.assert_close(b.cpu(), a, atol=1e-5, rtol=0, msg=name)


def test_prefetcher_copies_ahead_in_order(cuda_device):  # noqa: F811
    """Batches come out on the card, in order, equal to the host's; the
    host-side keys stay numpy."""
    rng = np.random.default_rng(4)
    loader = [{"frames": rng.integers(0, 256, (2, 3, 8, 8, 3), np.uint8),
               "labels": rng.integers(0, 5, 2), "pm": np.array([True, False])}
              for _ in range(5)]
    seen = list(DevicePrefetcher(loader, cuda_device, depth=2))
    assert len(seen) == len(loader)
    for want, (host, dev) in zip(loader, seen):
        assert host is want and dev["pm"] is want["pm"]
        assert dev["frames"].device.type == "cuda"
        np.testing.assert_array_equal(dev["frames"].cpu().numpy(), want["frames"])
        np.testing.assert_array_equal(dev["labels"].cpu().numpy(), want["labels"])
