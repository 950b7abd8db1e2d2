"""The flagship configuration, MViTv2-S 16x4, and its training recipe.

Counterparts of ``__graft_entry__`` at the repository's root:
``mvitv2_s_cfg`` builds the same configuration as ``_mvitv2_s_cfg``
(`MViT/configs/Kinetics/MVITv2_S_16x4.yaml`), or its tiny test variant;
``apply_bench_recipe`` sets the augmentation of ``apply_bench_recipe``.
"""

from pmv_tpu_torch.config import get_cfg


def mvitv2_s_cfg(tiny=False):
    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = "MViT"
    cfg.MODEL.ARCH = "mvit"
    cfg.MODEL.NUM_CLASSES = 400
    cfg.MODEL.LOSS_FUNC = "soft_cross_entropy"
    cfg.MIXUP.ENABLE = True
    cfg.AUG.ENABLE = False
    cfg.SOLVER.OPTIMIZING_METHOD = "adamw"
    cfg.SOLVER.CLIP_GRAD_L2NORM = 1.0
    cfg.SOLVER.ZERO_WD_1D_PARAM = True
    cfg.MVIT.ZERO_DECAY_POS_CLS = False
    cfg.MVIT.USE_ABS_POS = False
    cfg.MVIT.REL_POS_SPATIAL = True
    cfg.MVIT.REL_POS_TEMPORAL = True
    cfg.MVIT.QKV_BIAS = True
    cfg.MVIT.DROPPATH_RATE = 0.2
    cfg.MVIT.DIM_MUL_IN_ATT = True
    cfg.MVIT.RESIDUAL_POOLING = True
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    if tiny:
        cfg.MODEL.NUM_CLASSES = 8
        cfg.DATA.NUM_FRAMES = 2
        cfg.DATA.TRAIN_CROP_SIZE = 16
        cfg.DATA.TEST_CROP_SIZE = 16
        cfg.MVIT.DEPTH = 2
        cfg.MVIT.EMBED_DIM = 8
        cfg.MVIT.DIM_MUL = [[1, 2.0]]
        cfg.MVIT.HEAD_MUL = [[1, 2.0]]
        cfg.MVIT.POOL_KVQ_KERNEL = [1, 3, 3]
        cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
        cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    else:
        cfg.DATA.NUM_FRAMES = 16
        cfg.DATA.TRAIN_CROP_SIZE = 224
        cfg.DATA.TEST_CROP_SIZE = 224
        cfg.MVIT.DEPTH = 16
        cfg.MVIT.EMBED_DIM = 96
        cfg.MVIT.NUM_HEADS = 1
        cfg.MVIT.DIM_MUL = [[1, 2.0], [3, 2.0], [14, 2.0]]
        cfg.MVIT.HEAD_MUL = [[1, 2.0], [3, 2.0], [14, 2.0]]
        cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 8, 8]
        cfg.MVIT.POOL_Q_STRIDE = [
            [0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 1, 1], [3, 1, 2, 2],
            [4, 1, 1, 1], [5, 1, 1, 1], [6, 1, 1, 1], [7, 1, 1, 1],
            [8, 1, 1, 1], [9, 1, 1, 1], [10, 1, 1, 1], [11, 1, 1, 1],
            [12, 1, 1, 1], [13, 1, 1, 1], [14, 1, 2, 2], [15, 1, 1, 1],
        ]
    return cfg


def apply_bench_recipe(cfg):
    """The flagship training recipe of ``__graft_entry__.apply_bench_recipe``:
    on-device RandAugment rand-m7-n4-mstd0.5-inc1 and random erasing with
    p = 0.25. Its TPU.* keys and MVIT.FLAT_POOLS choose TPU layouts, which
    the port does not have."""
    cfg.AUG.ENABLE = True
    cfg.AUG.AA_TYPE = "rand-m7-n4-mstd0.5-inc1"
    cfg.AUG.RE_PROB = 0.25
    return cfg

