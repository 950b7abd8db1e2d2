"""Learning-rate policies (`MViT/slowfast/utils/lr_policy.py:9-94`).

The port's own copy of `pmv_tpu/utils/lr_policy.py`, plain Python: cosine
with COSINE_END_LR and optional COSINE_AFTER_WARMUP offset, steps with
relative LRs, and linear warmup blended per fractional epoch (epoch_exact =
epoch + iter / len). The engine computes one LR per iteration on the host
and hands it to the train step.
"""

import math


def get_lr_at_epoch(cfg, cur_epoch):
    """LR at a (fractional) epoch, with linear warmup to the policy curve."""
    lr = get_lr_func(cfg.SOLVER.LR_POLICY)(cfg, cur_epoch)
    if cur_epoch < cfg.SOLVER.WARMUP_EPOCHS:
        lr_start = cfg.SOLVER.WARMUP_START_LR
        lr_end = get_lr_func(cfg.SOLVER.LR_POLICY)(cfg, cfg.SOLVER.WARMUP_EPOCHS)
        alpha = (lr_end - lr_start) / cfg.SOLVER.WARMUP_EPOCHS
        lr = cur_epoch * alpha + lr_start
    return lr


def lr_func_cosine(cfg, cur_epoch):
    offset = cfg.SOLVER.WARMUP_EPOCHS if cfg.SOLVER.COSINE_AFTER_WARMUP else 0.0
    assert cfg.SOLVER.COSINE_END_LR < cfg.SOLVER.BASE_LR
    return (
        cfg.SOLVER.COSINE_END_LR
        + (cfg.SOLVER.BASE_LR - cfg.SOLVER.COSINE_END_LR)
        * (
            math.cos(
                math.pi * (cur_epoch - offset) / (cfg.SOLVER.MAX_EPOCH - offset)
            )
            + 1.0
        )
        * 0.5
    )


def lr_func_steps_with_relative_lrs(cfg, cur_epoch):
    ind = get_step_index(cfg, cur_epoch)
    return cfg.SOLVER.LRS[ind] * cfg.SOLVER.BASE_LR


def get_step_index(cfg, cur_epoch):
    steps = list(cfg.SOLVER.STEPS) + [cfg.SOLVER.MAX_EPOCH]
    for ind, step in enumerate(steps):
        if cur_epoch < step:
            break
    return ind - 1


def get_lr_func(lr_policy):
    policy = "lr_func_" + lr_policy
    if policy not in globals():
        raise NotImplementedError(f"Unknown LR policy: {lr_policy}")
    return globals()[policy]
