"""Multigrid training schedules (`MViT/slowfast/utils/multigrid.py:13-240`).

The port's own copy of `pmv_tpu/utils/multigrid.py`, numpy only, with the
same schedule, the same rewrite of SOLVER.STEPS, LRS and MAX_EPOCH, and the
same choice of BN.NORM_TYPE by the batch factor. Long cycles vary the
(batch, frames, crop) base shape over epochs; short cycles vary the crop
size across iterations within an epoch (``data/loader.py``). At a change of
the long-cycle shape ``engine/train.py`` builds the train loader anew and,
where the BatchNorm type changes, swaps the model's norms
(``models/batchnorm.py::swap_norms``), as the reference rebuilds its
trainer (`train_net.py:687-711`).
"""

import numpy as np

from pmv_tpu_torch.utils import logging as pmv_logging

logger = pmv_logging.get_logger(__name__)


class MultigridSchedule:
    def init_multigrid(self, cfg):
        """Record defaults and derive the long-cycle schedule + LR steps."""
        self.schedule = None
        cfg.MULTIGRID.DEFAULT_B = cfg.TRAIN.BATCH_SIZE
        cfg.MULTIGRID.DEFAULT_T = cfg.DATA.NUM_FRAMES
        cfg.MULTIGRID.DEFAULT_S = cfg.DATA.TRAIN_CROP_SIZE

        if cfg.MULTIGRID.LONG_CYCLE:
            self.schedule = self.get_long_cycle_schedule(cfg)
            cfg.SOLVER.STEPS = [0] + [s[-1] for s in self.schedule]
            # Fine-tuning phase splits the last step.
            cfg.SOLVER.STEPS[-1] = (
                cfg.SOLVER.STEPS[-2] + cfg.SOLVER.STEPS[-1]
            ) // 2
            cfg.SOLVER.LRS = [
                cfg.SOLVER.GAMMA ** s[0] * s[1][0] for s in self.schedule
            ]
            cfg.SOLVER.LRS = cfg.SOLVER.LRS[:-1] + [
                cfg.SOLVER.LRS[-2],
                cfg.SOLVER.LRS[-1],
            ]
            cfg.SOLVER.MAX_EPOCH = self.schedule[-1][-1]
        elif cfg.MULTIGRID.SHORT_CYCLE:
            cfg.SOLVER.STEPS = [
                int(s * cfg.MULTIGRID.EPOCH_FACTOR) for s in cfg.SOLVER.STEPS
            ]
            cfg.SOLVER.MAX_EPOCH = int(
                cfg.SOLVER.MAX_EPOCH * cfg.MULTIGRID.EPOCH_FACTOR
            )
        return cfg

    def update_long_cycle(self, cfg, cur_epoch):
        """Per-epoch base-shape update; returns (cfg, changed)."""
        base_b, base_t, base_s = get_current_long_cycle_shape(
            self.schedule, cur_epoch
        )
        if base_s == cfg.DATA.TRAIN_CROP_SIZE and base_t == cfg.DATA.NUM_FRAMES:
            return cfg, False
        cfg.DATA.NUM_FRAMES = base_t
        cfg.DATA.TRAIN_CROP_SIZE = base_s
        cfg.TRAIN.BATCH_SIZE = base_b * cfg.MULTIGRID.DEFAULT_B

        bs_factor = (
            float(cfg.TRAIN.BATCH_SIZE / max(cfg.NUM_GPUS, 1))
            / cfg.MULTIGRID.BN_BASE_SIZE
        )
        if bs_factor < 1:
            cfg.BN.NORM_TYPE = "sync_batchnorm"
            cfg.BN.NUM_SYNC_DEVICES = int(1.0 / bs_factor)
        elif bs_factor > 1:
            cfg.BN.NORM_TYPE = "sub_batchnorm"
            cfg.BN.NUM_SPLITS = int(bs_factor)
        else:
            cfg.BN.NORM_TYPE = "batchnorm"

        # Keep the clip duration constant: raise the sampling rate as the
        # frame count shrinks. Written to a separate key (the reference's
        # `multigrid.py:99`) so DATA.SAMPLING_RATE stays pristine across
        # cycle changes; datasets draw a random rate in
        # [SAMPLING_RATE, LONG_CYCLE_SAMPLING_RATE] (`utils.py:394-403`).
        cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE = cfg.DATA.SAMPLING_RATE * max(
            cfg.MULTIGRID.DEFAULT_T // cfg.DATA.NUM_FRAMES, 1
        )
        logger.info(
            "Long cycle update: B=%d T=%d S=%d BN=%s",
            cfg.TRAIN.BATCH_SIZE, base_t, base_s, cfg.BN.NORM_TYPE,
        )
        return cfg, True

    def get_long_cycle_schedule(self, cfg):
        """Derive the long-cycle (shape, epoch) schedule.

        This derivation mirrors `MViT/slowfast/utils/multigrid.py:123-180`
        variable-for-variable on purpose: the iteration-budget rebalancing
        loop IS the multigrid definition (Wu et al., CVPR 2020) and must
        produce identical schedules for checkpoint/recipe parity —
        tests/test_multigrid.py pins the derived schedules. Everything
        around it (the BN swap, the loader rebuilds) is the runtime's own."""
        steps = list(cfg.SOLVER.STEPS)
        default_size = float(cfg.DATA.NUM_FRAMES * cfg.DATA.TRAIN_CROP_SIZE ** 2)
        default_iters = steps[-1]

        avg_bs = []
        all_shapes = []
        for t_factor, s_factor in cfg.MULTIGRID.LONG_CYCLE_FACTORS:
            base_t = int(round(cfg.DATA.NUM_FRAMES * t_factor))
            base_s = int(round(cfg.DATA.TRAIN_CROP_SIZE * s_factor))
            if cfg.MULTIGRID.SHORT_CYCLE:
                shapes = [
                    [base_t,
                     int(cfg.MULTIGRID.DEFAULT_S
                         * cfg.MULTIGRID.SHORT_CYCLE_FACTORS[0])],
                    [base_t,
                     int(cfg.MULTIGRID.DEFAULT_S
                         * cfg.MULTIGRID.SHORT_CYCLE_FACTORS[1])],
                    [base_t, base_s],
                ]
            else:
                shapes = [[base_t, base_s]]
            shapes = [
                [int(round(default_size / (s[0] * s[1] * s[1]))), s[0], s[1]]
                for s in shapes
            ]
            avg_bs.append(np.mean([s[0] for s in shapes]))
            all_shapes.append(shapes)

        total_iters = 0
        schedule = []
        for step_index in range(len(steps) - 1):
            step_epochs = steps[step_index + 1] - steps[step_index]
            for long_cycle_index, shapes in enumerate(all_shapes):
                cur_epochs = (
                    step_epochs * avg_bs[long_cycle_index] / sum(avg_bs)
                )
                cur_iters = cur_epochs / avg_bs[long_cycle_index]
                total_iters += cur_iters
                schedule.append((step_index, shapes[-1], cur_epochs))

        iter_saving = default_iters / total_iters
        final_step_epochs = cfg.SOLVER.MAX_EPOCH - steps[-1]
        ft_epochs = final_step_epochs / iter_saving * avg_bs[-1]
        schedule.append((step_index + 1, all_shapes[-1][-1], ft_epochs))

        x = (
            cfg.SOLVER.MAX_EPOCH
            * cfg.MULTIGRID.EPOCH_FACTOR
            / sum(s[-1] for s in schedule)
        )
        final_schedule = []
        total_epochs = 0
        for s in schedule:
            epochs = s[2] * x
            total_epochs += epochs
            final_schedule.append((s[0], s[1], int(round(total_epochs))))
        for s in final_schedule:
            logger.info("long-cycle %d shape %s until epoch %d", *s)
        return final_schedule


def get_current_long_cycle_shape(schedule, epoch):
    for s in schedule:
        if epoch < s[-1]:
            return s[1]
    return schedule[-1][1]


def short_cycle_crop_size(cur_iter, cfg):
    """Per-iteration crop size within a short cycle
    (`datasets/multigrid_helper.py` ShortCycleBatchSampler semantics)."""
    if not cfg.MULTIGRID.SHORT_CYCLE:
        return cfg.DATA.TRAIN_CROP_SIZE
    phase = cur_iter % 3
    if phase < 2:
        return int(
            round(
                cfg.MULTIGRID.SHORT_CYCLE_FACTORS[phase]
                * cfg.MULTIGRID.DEFAULT_S
            )
        )
    return cfg.DATA.TRAIN_CROP_SIZE
