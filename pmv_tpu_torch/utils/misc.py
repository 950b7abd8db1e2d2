"""Model and schedule helpers (`pmv_tpu/utils/misc.py`,
`MViT/slowfast/utils/misc.py`).

``log_model_info`` logs the parameter count, the device memory and, for
one clip of the eval forward, the FLOPs and the activations
(``model_stats``). The JAX package reads the activations off the jaxpr
(the outputs of every ``dot_general`` and ``conv_general_dilated``,
fvcore's definition) and the FLOPs off XLA's cost model, which also counts
elementwise work; here both come from the aten ops of a forward on the
``meta`` device, which holds shapes and computes nothing: the activations
are the outputs of every matmul and conv, the FLOPs 2 x their MACs
(``torch.utils.flop_counter``). K1 counts as the depthwise conv it computes
(``models/common.py::channels_last_conv3d`` takes ``F.conv3d`` on meta
tensors).
"""

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils.meters import gpu_mem_usage

logger = pmv_logging.get_logger(__name__)


def params_count(model):
    """Total parameter count of ``model``."""
    return sum(p.numel() for p in model.parameters())


def log_model_info(model, cfg=None):
    """Log params and memory at job start (`misc.py:166-226`) and, given the
    job's ``cfg``, on rank 0, the FLOPs and the activations of the eval
    forward on one clip of its crop (``model_stats``), as the JAX package
    logs them; not under DETECTION.ENABLE, where the JAX package counts
    nothing. A model whose forward takes more than a clip (AVSlowFast's
    audio: the JAX package's count fails there too) logs a warning
    instead."""
    from pmv_tpu_torch.models.mvit import geometry
    from pmv_tpu_torch.utils.device import rank_and_world_size

    logger.info("Params: %s", f"{params_count(model):,}")
    logger.info("Mem: %.2f GB", gpu_mem_usage())
    if cfg is None or cfg.DETECTION.ENABLE or rank_and_world_size()[0] != 0:
        return
    try:
        flops, activations = model_stats(cfg, [*geometry(cfg), 3])
    except (TypeError, ValueError, RuntimeError, NotImplementedError) as e:
        logger.warning("Flops and activations not counted: %s", e)
        return
    logger.info("Flops: %.2f G / clip", flops / 1e9)
    logger.info("Activations: %.2f M / clip", activations / 1e6)


# The aten ops of a matmul or a conv: fvcore's activations are their outputs.
_COUNTED = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
            torch.ops.aten.baddbmm, torch.ops.aten.convolution, torch.ops.aten._convolution}


class _Count(TorchDispatchMode):
    """The outputs' elements and the FLOPs (``torch.utils.flop_counter``'s
    count of each op: 2 x its MACs) of every op of ``_COUNTED`` run within."""

    def __init__(self):
        super().__init__()
        self.flops = self.activations = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.overloadpacket in _COUNTED:
            self.activations += out.numel()
            self.flops += flop_registry[func.overloadpacket](*args, **kwargs, out_val=out)
        return out


def model_stats(cfg, clip_shape):
    """(FLOPs, activations) of the eval forward of cfg.MODEL.MODEL_NAME on
    one clip of ``clip_shape`` ([T, H, W, C]), counted on a copy of the
    model on the ``meta`` device (no weights, no compute). MaskMViT runs
    with nothing masked; a SlowFast clip is packed into its pathways."""
    from pmv_tpu_torch.engine.steps import model_input
    from pmv_tpu_torch.models.build import MODEL_REGISTRY

    with torch.device("meta"):
        model = MODEL_REGISTRY.get(cfg.MODEL.MODEL_NAME)(cfg, dtype=torch.float32).eval()
        x = model_input(cfg, torch.zeros((1, *clip_shape)))
        args = (x,)
        if hasattr(model, "token_grid"):  # MaskMViT: its mask, none masked
            args += (torch.zeros((1, math.prod(model.token_grid(x.shape))), dtype=torch.bool),)
    count = _Count()
    with torch.no_grad(), count:
        model(*args)
    return count.flops, count.activations


def is_eval_epoch(cfg, cur_epoch, multigrid_schedule=None):
    """Eval on EVAL_PERIOD boundaries and at the final epoch; under multigrid
    long cycles (``multigrid_schedule``), EVAL_FREQ times a cycle, aligned
    to the cycle's end (`misc.py:228-250`)."""
    if cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH:
        return True
    if multigrid_schedule is not None:
        prev_epoch = 0
        for s in multigrid_schedule:
            if cur_epoch < s[-1]:
                period = max((s[-1] - prev_epoch) // cfg.MULTIGRID.EVAL_FREQ + 1, 1)
                return (s[-1] - 1 - cur_epoch) % period == 0
            prev_epoch = s[-1]
    return (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0
