"""Default config tree.

Mirrors the key groups and semantics of the reference config surface
(`MViT/slowfast/config/defaults.py:13-1364` plus the UniFormer fork's extras,
`Uniformer/slowfast/config/defaults.py:312-456`) so the reference's
`exps/PMV/*.sh` recipes port unchanged. TPU-specific keys live under `TPU.*`.
"""

import math

from pmv_tpu_torch.config.cfg_node import CfgNode

_C = CfgNode()

# ---------------------------------------------------------------------- TRAIN
_C.TRAIN = CfgNode()
_C.TRAIN.ENABLE = True
_C.TRAIN.DATASET = "kinetics"
_C.TRAIN.BATCH_SIZE = 64
_C.TRAIN.EVAL_PERIOD = 10
_C.TRAIN.CHECKPOINT_PERIOD = 10
_C.TRAIN.AUTO_RESUME = True
_C.TRAIN.CHECKPOINT_FILE_PATH = ""
_C.TRAIN.CHECKPOINT_TYPE = "pytorch"  # pytorch | caffe2 | orbax
_C.TRAIN.CHECKPOINT_INFLATE = False
_C.TRAIN.CHECKPOINT_EPOCH_RESET = False
_C.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN = ()
_C.TRAIN.CHECKPOINT_IN_INIT = False
_C.TRAIN.MIXED_PRECISION = True  # bf16 activations on TPU (no loss scaling)
_C.TRAIN.KILL_LOSS_EXPLOSION_FACTOR = 0.0
# Dense-position eval crops (`defaults.py:174-175`).
_C.TRAIN.SPATIAL_SAMPLE_INDEX = -1
_C.TRAIN.SPATIAL_SAMPLE_RATIO = [0.5, 0.5]

# ------------------------------------------------------------------------ AUG
_C.AUG = CfgNode()
_C.AUG.ENABLE = False
_C.AUG.GEN_MASK_LOADER = False
_C.AUG.NUM_SAMPLE = 1
_C.AUG.COLOR_JITTER = 0.4
_C.AUG.AA_TYPE = "rand-m9-mstd0.5-inc1"
_C.AUG.INTERPOLATION = "bicubic"
_C.AUG.RE_PROB = 0.25
_C.AUG.RE_MODE = "pixel"
_C.AUG.RE_COUNT = 1
_C.AUG.RE_SPLIT = False
# On-device RandAugment op-sampling granularity: how many batch chunks draw
# independent op chains per step. 0/-1 = one chain per clip (the reference's
# per-clip CPU sampling, `kinetics.py:429`; measured +0.7% step time on v5e,
# so parity is the default); N > 0 = N chunks (cheaper compile).
_C.AUG.RA_GROUPS = 0
_C.AUG.MASK_FRAMES = False
_C.AUG.MASK_TUBE = False
_C.AUG.MASK_WINDOW_SIZE = [8, 7, 7]
_C.AUG.MASK_RATIO = 0.0
_C.AUG.MAX_MASK_PATCHES_PER_BLOCK = None

# ---------------------------------------------------------------------- MIXUP
_C.MIXUP = CfgNode()
_C.MIXUP.ENABLE = False
_C.MIXUP.ALPHA = 0.8
_C.MIXUP.CUTMIX_ALPHA = 1.0
_C.MIXUP.PROB = 1.0
_C.MIXUP.SWITCH_PROB = 0.5
_C.MIXUP.LABEL_SMOOTH_VALUE = 0.1

# ----------------------------------------------------------------------- TEST
_C.TEST = CfgNode()
_C.TEST.ENABLE = True
_C.TEST.DATASET = "kinetics"
_C.TEST.BATCH_SIZE = 8
_C.TEST.CHECKPOINT_FILE_PATH = ""
_C.TEST.NUM_ENSEMBLE_VIEWS = 10
# Per-protocol temporal-clip sweep: when non-empty, test() runs once per
# entry with that many ensemble views (`test_net.py:400-401` sweep).
_C.TEST.NUM_TEMPORAL_CLIPS = []
_C.TEST.NUM_SPATIAL_CROPS = 3
_C.TEST.CHECKPOINT_TYPE = "pytorch"
_C.TEST.SAVE_RESULTS_PATH = ""
# Internal flag: are we building the model for the test pipeline (selects
# TEST_CROP_SIZE_RECT vs TRAIN_CROP_SIZE_RECT, `video_model_builder.py:1747`).
_C.TEST.PROCESS = False
_C.TEST.FEAT_EXTRACT = False
_C.TEST.SPATIAL_SAMPLE_INDEX = 1  # center crop (`defaults.py:286`)
_C.TEST.SPATIAL_SAMPLE_RATIO = [0.5, 0.5]
# Dense spatial crop sweep over a ratio grid (`defaults.py:286-289`).
_C.TEST.DENSE_SPATIAL_CROP = False
_C.TEST.DENSE_SPATIAL_CROP_STEPS = 5

# ---------------------------------------------------------------------- MODEL
_C.MODEL = CfgNode()
_C.MODEL.MODEL_NAME = "SlowFast"
_C.MODEL.ARCH = "slowfast"
_C.MODEL.NUM_CLASSES = 400
_C.MODEL.LOSS_FUNC = "cross_entropy"
_C.MODEL.DROPOUT_RATE = 0.5
_C.MODEL.DROPCONNECT_RATE = 0.0
_C.MODEL.HEAD_ACT = "softmax"
_C.MODEL.FC_INIT_STD = 0.01
_C.MODEL.ZERO_INIT_FINAL_BN = False
_C.MODEL.ZERO_INIT_FINAL_CONV = False
_C.MODEL.SINGLE_PATHWAY_ARCH = [
    "2d", "c2d", "i3d", "slow", "x3d", "mvit", "maskmvit", "uniformer",
    "csn", "r2plus1d",
]
_C.MODEL.MULTI_PATHWAY_ARCH = ["slowfast", "avslowfast"]
# Accepted for config parity; on TPU, XLA chooses collective precision.
_C.MODEL.FP16_ALLREDUCE = False
_C.MODEL.ACT_CHECKPOINT = False  # remat MViT blocks via jax.checkpoint
_C.MODEL.DETACH_FINAL_FC = False
_C.MODEL.FROZEN_BN = False
# UniFormer fork extras (`Uniformer/slowfast/config/defaults.py`).
_C.MODEL.USE_CHECKPOINT = False
_C.MODEL.CHECKPOINT_NUM = [0, 0, 0, 0]

# ----------------------------------------------------------------------- MVIT
_C.MVIT = CfgNode()
_C.MVIT.MODE = "conv"
_C.MVIT.POOL_FIRST = False
_C.MVIT.CLS_EMBED_ON = True
_C.MVIT.PATCH_KERNEL = [3, 7, 7]
_C.MVIT.PATCH_STRIDE = [2, 4, 4]
_C.MVIT.PATCH_PADDING = [1, 3, 3]
_C.MVIT.PATCH_2D = False
_C.MVIT.EMBED_DIM = 96
_C.MVIT.NUM_HEADS = 1
_C.MVIT.MLP_RATIO = 4.0
_C.MVIT.QKV_BIAS = True
_C.MVIT.DROPPATH_RATE = 0.1
_C.MVIT.LAYER_SCALE_INIT_VALUE = 0.0
_C.MVIT.DEPTH = 16
_C.MVIT.DROPOUT_RATE = 0.0
_C.MVIT.DIM_MUL = []
_C.MVIT.HEAD_MUL = []
_C.MVIT.POOL_KV_STRIDE = []
_C.MVIT.POOL_KV_STRIDE_ADAPTIVE = None
_C.MVIT.POOL_Q_STRIDE = []
_C.MVIT.POOL_KVQ_KERNEL = None
_C.MVIT.ZERO_DECAY_POS_CLS = True
_C.MVIT.NORM = "layernorm"
_C.MVIT.NORM_STEM = False
_C.MVIT.SEP_POS_EMBED = False
_C.MVIT.DROPOUT_RATE = 0.0
_C.MVIT.USE_ABS_POS = True
_C.MVIT.REL_POS_SPATIAL = False
_C.MVIT.REL_POS_TEMPORAL = False
_C.MVIT.REL_POS_ZERO_INIT = False
_C.MVIT.RESIDUAL_POOLING = False
_C.MVIT.DIM_MUL_IN_ATT = False
_C.MVIT.SEPARATE_QKV = False
_C.MVIT.HEAD_INIT_SCALE = 1.0
_C.MVIT.USE_MEAN_POOLING = False
_C.MVIT.USE_FIXED_SINCOS_POS = False
# TPU: hand-written depthwise conv kernel for the stride-1 3x3x3 pooling
# convs. Off by default: measured SLOWER than XLA's grouped conv on v5e
# (full step 200 vs 172 ms; kernel fwd 1.7 vs 0.3 ms at stage 1 — the
# unaligned sublane taps dominate). Kept for further kernel work.
_C.MVIT.USE_PALLAS_POOLS = False
# Depthwise pool-conv lowering: "xla"/"auto" grouped conv (the measured
# winner) | "pallas" hand-written stride-1 3x3x3 kernel | "slice"
# (diagnostic subsampling, wrong math — perf bounding only). The losing
# lowerings from rounds 1-3 (shift/custom_vjp/ncdhw/window/token_shift)
# were deleted; see ROADMAP.md dead ends and git history.
_C.MVIT.POOL_CONV_IMPL = "xla"
# Decimated K/V projection+pool for disjoint pool windows (stride >= kernel,
# the POOL_KV_STRIDE_ADAPTIVE stage-1/2 geometries): project only the token
# rows the strided conv reads (9/64 at stride 8). Exact; no grouped conv.
_C.MVIT.SPARSE_KV_POOL = True

# Keep q/k/v in the flat [B, N, heads*C] layout through the pools (per-head
# 4-d form created once at the attention einsums); the pool-boundary
# [B,N,H,C] <-> grid reshapes are physical relayout copies on TPU. Exact same
# math and parameter tree (pool LayerNorm computed per C-block, FlatGroupLN).
_C.MVIT.FLAT_POOLS = False
# Per-DATA-SHARD batch above which FLAT_POOLS falls back to the 4-d pool
# layout (the builder scales this by the data-axis size before comparing
# against the global jit-traced batch, and logs once on fallback): the flat
# lowering at batch 32/chip reliably crashed the remote TPU compile helper
# (HTTP 500, round-3 probes) while every reference recipe runs 4-12
# clips/chip. 0 = no limit.
_C.MVIT.FLAT_POOLS_MAX_BATCH = 16
# Attention einsum lowering: "batched" one bhqk einsum over (b, h) |
# "per_head" head-sliced bqk einsums (no h<->q relayout of q/probs).
_C.MVIT.ATTN_IMPL = "batched"

# ------------------------------------------------------------------ UNIFORMER
_C.UNIFORMER = CfgNode()
_C.UNIFORMER.EMBED_DIM = [64, 128, 320, 512]
_C.UNIFORMER.DEPTH = [3, 4, 8, 3]
_C.UNIFORMER.HEAD_DIM = 64
_C.UNIFORMER.MLP_RATIO = 4.0
_C.UNIFORMER.QKV_BIAS = True
_C.UNIFORMER.QKV_SCALE = None
_C.UNIFORMER.REPRESENTATION_SIZE = None
_C.UNIFORMER.DROPOUT_RATE = 0.0
_C.UNIFORMER.ATTENTION_DROPOUT_RATE = 0.0
_C.UNIFORMER.DROP_DEPTH_RATE = 0.1
_C.UNIFORMER.SPLIT = False
_C.UNIFORMER.STD = False
_C.UNIFORMER.FRAME_BASE = False
_C.UNIFORMER.PRETRAIN_NAME = ""
# Fork extras (`Uniformer/slowfast/config/defaults.py:419-459`): stem patch
# geometry overrides ([] = built-in 4/2 stems) and stage kinds (0 = conv
# CBlock, 1 = self-attention SABlock).
_C.UNIFORMER.PATCH_KERNEL = []
_C.UNIFORMER.PATCH_STRIDE = []
_C.UNIFORMER.PATCH_PADDING = []
_C.UNIFORMER.STAGE_TYPE = [0, 0, 1, 1]
# Attention lowering for SA blocks: "batched" | "per_head" (tokens-major
# weight-slice dots, no qkv/probs relayouts — see MVIT.ATTN_IMPL).
_C.UNIFORMER.ATTN_IMPL = "batched"

# ------------------------------------------------------------------------ X3D
_C.X3D = CfgNode()
_C.X3D.WIDTH_FACTOR = 1.0
_C.X3D.DEPTH_FACTOR = 1.0
_C.X3D.BOTTLENECK_FACTOR = 1.0
_C.X3D.DIM_C5 = 2048
_C.X3D.DIM_C1 = 12
_C.X3D.SCALE_RES2 = False
_C.X3D.BN_LIN5 = False
_C.X3D.CHANNELWISE_3x3x3 = True

# --------------------------------------------------------------------- RESNET
_C.RESNET = CfgNode()
_C.RESNET.AUDIO_TRANS_FUNC = "tf_bottleneck_transform"
_C.RESNET.AUDIO_TRANS_NUM = 2
_C.RESNET.TRANS_FUNC = "bottleneck_transform"
_C.RESNET.NUM_GROUPS = 1
_C.RESNET.WIDTH_PER_GROUP = 64
_C.RESNET.INPLACE_RELU = True
_C.RESNET.STRIDE_1X1 = False
_C.RESNET.ZERO_INIT_FINAL_BN = False
_C.RESNET.ZERO_INIT_FINAL_CONV = False
_C.RESNET.DEPTH = 50
_C.RESNET.NUM_BLOCK_TEMP_KERNEL = [[3], [4], [6], [3]]
_C.RESNET.SPATIAL_STRIDES = [[1], [2], [2], [2]]
_C.RESNET.SPATIAL_DILATIONS = [[1], [1], [1], [1]]

# ------------------------------------------------------------------- NONLOCAL
_C.NONLOCAL = CfgNode()
_C.NONLOCAL.LOCATION = [[[]], [[]], [[]], [[]]]
_C.NONLOCAL.GROUP = [[1], [1], [1], [1]]
_C.NONLOCAL.INSTANTIATION = "dot_product"
_C.NONLOCAL.POOL = [
    [[1, 2, 2], [1, 2, 2]],
    [[1, 2, 2], [1, 2, 2]],
    [[1, 2, 2], [1, 2, 2]],
    [[1, 2, 2], [1, 2, 2]],
]

# ------------------------------------------------------------------- SLOWFAST
_C.SLOWFAST = CfgNode()
_C.SLOWFAST.BETA_INV = 8
_C.SLOWFAST.ALPHA = 8
_C.SLOWFAST.FUSION_CONV_CHANNEL_RATIO = 2
_C.SLOWFAST.FUSION_KERNEL_SZ = 5
# --- AVSlowFast audio pathway + fusion (`defaults.py:645-674`)
_C.SLOWFAST.AU_BETA_INV = 2
_C.SLOWFAST.AU_ALPHA = 32
_C.SLOWFAST.AU_FUSION_CONV_CHANNEL_RATIO = 0.125
_C.SLOWFAST.AU_FUSION_CONV_CHANNEL_DIM = 64
_C.SLOWFAST.AU_FUSION_CONV_CHANNEL_MODE = "ByRatio"  # ByDim, ByRatio
_C.SLOWFAST.AU_FUSION_KERNEL_SZ = 5
_C.SLOWFAST.AU_FUSION_CONV_NUM = 2
_C.SLOWFAST.AU_REDUCE_TF_DIM = True
# Per-junction fusion connections (after s1..s4).
_C.SLOWFAST.FS_FUSION = [True, True, True, True]
_C.SLOWFAST.AFS_FUSION = [True, True, True, True]
# Per-junction audio-visual sync loss (after s1..s5).
_C.SLOWFAST.AVS_FLAG = [False, False, False, False, False]
_C.SLOWFAST.AVS_PROJ_DIM = 64
_C.SLOWFAST.AVS_VAR_THRESH = 0.01
_C.SLOWFAST.AVS_DUPLICATE_THRESH = 0.99
# Drop the audio->visual fusion for a step with this probability (train).
_C.SLOWFAST.DROPPATHWAY_RATE = 0.8

# ------------------------------------------------------------------------- BN
_C.BN = CfgNode()
_C.BN.USE_PRECISE_STATS = False
_C.BN.NUM_BATCHES_PRECISE = 200
_C.BN.WEIGHT_DECAY = 0.0
_C.BN.NORM_TYPE = "batchnorm"  # batchnorm | sub_batchnorm | sync_batchnorm
_C.BN.NUM_SPLITS = 1
_C.BN.NUM_SYNC_DEVICES = 1
_C.BN.GLOBAL_SYNC = False

# ----------------------------------------------------------------------- DATA
_C.DATA = CfgNode()
_C.DATA.PATH_TO_DATA_DIR = ""
_C.DATA.PATH_PREFIX = ""
_C.DATA.PATH_LABEL_SEPARATOR = " "
# PMV subset tag formatted into the split CSV name (`defaults.py:681`).
_C.DATA.PM_SUBSET = ""
# "{}{}.csv".format(mode, PM_SUBSET) (`defaults.py:688`, `kinetics.py:110-112`).
_C.DATA.LABEL_PATH_TEMPLATE = "{}{}.csv"
_C.DATA.IMAGE_TEMPLATE = "{:05d}.jpg"
_C.DATA.CAMERA_VIEWS = []
_C.DATA.MEAN = [0.45, 0.45, 0.45]
_C.DATA.STD = [0.225, 0.225, 0.225]
_C.DATA.NUM_FRAMES = 8
_C.DATA.SAMPLING_RATE = 8
_C.DATA.TARGET_FPS = 30
# --- audio (AVSlowFast; `defaults.py:762-782`)
_C.DATA.USE_AUDIO = False
_C.DATA.GET_MISALIGNED_AUDIO = False
_C.DATA.AUDIO_SAMPLE_RATE = 16000
_C.DATA.AUDIO_WIN_SZ = 32
_C.DATA.AUDIO_STEP_SZ = 16
_C.DATA.AUDIO_FRAME_NUM = 128
_C.DATA.AUDIO_MEL_NUM = 40
_C.DATA.AUDIO_MISALIGNED_GAP = 32
_C.DATA.LOGMEL_MEAN = 0.0
_C.DATA.LOGMEL_STD = 1.0
_C.DATA.TRAIN_JITTER_SCALES = [256, 320]
_C.DATA.TRAIN_JITTER_SCALES_RELATIVE = []
_C.DATA.TRAIN_JITTER_ASPECT_RELATIVE = []
# Auto-raise min jitter scale so a rect crop fits extreme aspect ratios
# (`datasets/utils.py:120-135`, `defaults.py:734-735`).
_C.DATA.TRAIN_JITTER_SCALES_AUTO_ADJUST = False
_C.DATA.TEST_JITTER_SCALES_AUTO_ADJUST = False
_C.DATA.TRAIN_JITTER_MOTION_SHIFT = False
_C.DATA.TRAIN_CROP_SIZE = 224
# PMV rectangular (portrait 9:16-aware) crops (`defaults.py:753-754,758-759`).
_C.DATA.TRAIN_CROP_SIZE_RECT = []
_C.DATA.TRAIN_CROP_SIZE_RECT_SWITCH_AUTO = False
_C.DATA.TEST_CROP_SIZE = 256
_C.DATA.TEST_CROP_SIZE_RECT = []
_C.DATA.TEST_CROP_SIZE_RECT_SWITCH_AUTO = False
_C.DATA.INPUT_CHANNEL_NUM = [3, 3]
_C.DATA.DECODING_BACKEND = "ffmpeg"  # native libav decoder
_C.DATA.INV_UNIFORM_SAMPLE = False
_C.DATA.RANDOM_FLIP = True
_C.DATA.MULTI_LABEL = False
_C.DATA.ENSEMBLE_METHOD = "sum"
_C.DATA.REVERSE_INPUT_CHANNEL = False
_C.DATA.CROP_SIZE = 224
_C.DATA.DECODING_SHORT_SIZE = 256
_C.DATA.EASY_NEG_RATIO = 0.75
_C.DATA.MIX_NEG_EPOCH = 96
_C.DATA.PATH_TO_PRELOAD_IMDB = ""
_C.DATA.TRAIN_JITTER_FPS = 0.0
# PCA lighting-jitter statistics (AlexNet-style, `defaults.py:703-712`).
_C.DATA.TRAIN_PCA_EIGVAL = [0.225, 0.224, 0.229]
_C.DATA.TRAIN_PCA_EIGVEC = [
    [-0.5675, 0.7192, 0.4009],
    [-0.5808, -0.0045, -0.8140],
    [-0.5836, -0.6948, 0.4203],
]
_C.DATA.USE_BGR_ORDER = False
_C.DATA.USE_OFFSET_SAMPLING = False
_C.DATA.TRAIN_CROP_NUM_TEMPORAL = 1
_C.DATA.TRAIN_CROP_NUM_SPATIAL = 1
_C.DATA.COLOR_RND_GRAYSCALE = 0.0
_C.DATA.TIME_DIFF_PROB = 0.0
_C.DATA.SSL_COLOR_JITTER = False
_C.DATA.SSL_COLOR_BRI_CON_SAT = [0.4, 0.4, 0.4]
_C.DATA.SSL_COLOR_HUE = 0.1
_C.DATA.SSL_MOCOV2_AUG = False
_C.DATA.SSL_BLUR_SIGMA_MIN = [0.0, 0.1]
_C.DATA.SSL_BLUR_SIGMA_MAX = [0.0, 2.0]
_C.DATA.IN22K_TRAINVAL = False
_C.DATA.IN22k_VAL_IN1K = ""
_C.DATA.DUMMY_LOAD = False
_C.DATA.SKIP_ROWS = 0
_C.DATA.LOADER_CHUNK_SIZE = 0
_C.DATA.LOADER_CHUNK_OVERALL_SIZE = 0
_C.DATA.MIN_DELTA = -math.inf
_C.DATA.MAX_DELTA = math.inf

# --------------------------------------------------------------------- SOLVER
_C.SOLVER = CfgNode()
_C.SOLVER.BASE_LR = 0.1
_C.SOLVER.LR_POLICY = "cosine"
_C.SOLVER.COSINE_END_LR = 0.0
_C.SOLVER.COSINE_AFTER_WARMUP = False
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEP_SIZE = 1
_C.SOLVER.STEPS = []
_C.SOLVER.LRS = []
_C.SOLVER.MAX_EPOCH = 300
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.DAMPENING = 0.0
_C.SOLVER.NESTEROV = True
_C.SOLVER.WEIGHT_DECAY = 1e-4
_C.SOLVER.WARMUP_FACTOR = 0.1
_C.SOLVER.WARMUP_EPOCHS = 0.0
_C.SOLVER.WARMUP_START_LR = 0.01
_C.SOLVER.OPTIMIZING_METHOD = "sgd"
_C.SOLVER.LARS_ON = False
_C.SOLVER.BASE_LR_SCALE_NUM_SHARDS = False
_C.SOLVER.BASE_LR_SCALE_NUM_SHARDS_BY_SQRT = False
_C.SOLVER.CLIP_GRAD_VAL = None
_C.SOLVER.CLIP_GRAD_L2NORM = None
# UniFormer fork alias for CLIP_GRAD_L2NORM.
_C.SOLVER.CLIP_GRADIENT = None
_C.SOLVER.LAYER_DECAY = 1.0
_C.SOLVER.BETAS = (0.9, 0.999)
_C.SOLVER.ZERO_WD_1D_PARAM = False

# ----------------------------------------------------------------------- MISC
_C.NUM_GPUS = 1  # processes (one per card) on each host
_C.NUM_SHARDS = 1
_C.SHARD_ID = 0
_C.OUTPUT_DIR = "."
_C.RNG_SEED = 1
# torch.distributed backend: "nccl", "gloo", or "ici" (the JAX package's
# value): NCCL on CUDA, gloo on the CPU (parallel/distributed.py).
_C.DIST_BACKEND = "ici"
_C.LOG_PERIOD = 10
_C.LOG_MODEL_INFO = True
_C.TASK = ""

# ---------------------------------------------------------------- DATA_LOADER
_C.DATA_LOADER = CfgNode()
_C.DATA_LOADER.NUM_WORKERS = 8
_C.DATA_LOADER.PIN_MEMORY = True
_C.DATA_LOADER.ENABLE_MULTI_THREAD_DECODE = False
_C.DATA_LOADER.PREFETCH_DEPTH = 2

# ------------------------------------------------------------------ BENCHMARK
_C.BENCHMARK = CfgNode()
_C.BENCHMARK.NUM_EPOCHS = 5
_C.BENCHMARK.LOG_PERIOD = 100
_C.BENCHMARK.SHUFFLE = True

# -------------------------------------------------------------------- DETECTION
_C.DETECTION = CfgNode()
_C.DETECTION.ENABLE = False
_C.DETECTION.ALIGNED = True
_C.DETECTION.SPATIAL_SCALE_FACTOR = 16
_C.DETECTION.ROI_XFORM_RESOLUTION = 7

# ------------------------------------------------------------------------ AVA
_C.AVA = CfgNode()
_C.AVA.FRAME_DIR = ""
_C.AVA.FRAME_LIST_DIR = ""
_C.AVA.ANNOTATION_DIR = ""
_C.AVA.TRAIN_LISTS = ["train.csv"]
_C.AVA.TEST_LISTS = ["val.csv"]
_C.AVA.TRAIN_GT_BOX_LISTS = ["ava_train_v2.2.csv"]
_C.AVA.TRAIN_PREDICT_BOX_LISTS = []
_C.AVA.TEST_PREDICT_BOX_LISTS = ["ava_val_predicted_boxes.csv"]
_C.AVA.DETECTION_SCORE_THRESH = 0.9
_C.AVA.BGR = False
_C.AVA.TRAIN_USE_COLOR_AUGMENTATION = False
_C.AVA.TRAIN_PCA_JITTER_ONLY = True
_C.AVA.TEST_FORCE_FLIP = False
_C.AVA.FULL_TEST_ON_VAL = False
_C.AVA.LABEL_MAP_FILE = "ava_action_list_v2.2_for_activitynet_2019.pbtxt"
_C.AVA.EXCLUSION_FILE = "ava_val_excluded_timestamps_v2.2.csv"
_C.AVA.GROUNDTRUTH_FILE = "ava_val_v2.2.csv"
_C.AVA.IMG_PROC_BACKEND = "pil"

# ------------------------------------------------------------------ MULTIGRID
_C.MULTIGRID = CfgNode()
_C.MULTIGRID.LONG_CYCLE = False
_C.MULTIGRID.SHORT_CYCLE = False
_C.MULTIGRID.LONG_CYCLE_SAMPLING_RATE = 0
_C.MULTIGRID.LONG_CYCLE_FACTORS = [
    (0.25, 0.7071067811865476),
    (0.5, 0.7071067811865476),
    (0.5, 1.0),
    (1.0, 1.0),
]
_C.MULTIGRID.SHORT_CYCLE_FACTORS = [0.5, 0.7071067811865476]
_C.MULTIGRID.EPOCH_FACTOR = 1.5
_C.MULTIGRID.EVAL_FREQ = 3
_C.MULTIGRID.BN_BASE_SIZE = 8
_C.MULTIGRID.DEFAULT_B = 0
_C.MULTIGRID.DEFAULT_T = 0
_C.MULTIGRID.DEFAULT_S = 0

# ---------------------------------------------------------------- CONTRASTIVE
_C.CONTRASTIVE = CfgNode()
_C.CONTRASTIVE.T = 0.07
_C.CONTRASTIVE.TYPE = "mem"
_C.CONTRASTIVE.DIM = 128
_C.CONTRASTIVE.LENGTH = 239975
_C.CONTRASTIVE.QUEUE_LEN = 65536
_C.CONTRASTIVE.MOMENTUM = 0.5
_C.CONTRASTIVE.MOMENTUM_ANNEALING = False
_C.CONTRASTIVE.NUM_MLP_LAYERS = 1
_C.CONTRASTIVE.MLP_DIM = 2048
_C.CONTRASTIVE.BN_MLP = False
_C.CONTRASTIVE.BN_SYNC_MLP = False
_C.CONTRASTIVE.LOCAL_SHUFFLE_BN = True
_C.CONTRASTIVE.MOCO_MULTI_VIEW_QUEUE = False
_C.CONTRASTIVE.DELTA_CLIPS_MIN = -math.inf
_C.CONTRASTIVE.DELTA_CLIPS_MAX = math.inf
_C.CONTRASTIVE.PREDICTOR_DEPTHS = []
_C.CONTRASTIVE.SEQUENTIAL = False
_C.CONTRASTIVE.SIMCLR_DIST_ON = True
_C.CONTRASTIVE.SWAV_QEUE_LEN = 0
_C.CONTRASTIVE.KNN_ON = True
_C.CONTRASTIVE.INTERP_MEMORY = False
_C.CONTRASTIVE.MEM_TYPE = "1d"
_C.CONTRASTIVE.NUM_CLASSES_DOWNSTREAM = 400
_C.CONTRASTIVE.KNN_DOWNSTREAM_SIZE = 239975

# ----------------------------------------------------------------------- MASK
_C.MASK = CfgNode()
_C.MASK.ENABLE = False
_C.MASK.MAE_ON = False
_C.MASK.MAE_RND_MASK = False
_C.MASK.PER_FRAME_MASKING = False
_C.MASK.TIME_STRIDE_LOSS = True
_C.MASK.NORM_PRED_PIXEL = True
_C.MASK.SCALE_INIT_BY_DEPTH = False
_C.MASK.PRETRAIN_DEPTH = [15]
_C.MASK.HEAD_TYPE = "separate"
_C.MASK.DECODER_EMBED_DIM = 512
_C.MASK.DECODER_DEPTH = 0
_C.MASK.DECODER_SEP_POS_EMBED = False
_C.MASK.DEC_KV_KERNEL = []
_C.MASK.DEC_KV_STRIDE = []
_C.MASK.DEC_NUM_HEADS = 1
_C.MASK.PRED_HOG = False
_C.MASK.HOG_NBINS = 9
_C.MASK.HOG_CELL_SZ = 8

# ---------------------------------------------------------------- TENSORBOARD
_C.TENSORBOARD = CfgNode()
_C.TENSORBOARD.ENABLE = False
_C.TENSORBOARD.LOG_DIR = ""
_C.TENSORBOARD.CLASS_NAMES_PATH = ""
_C.TENSORBOARD.CATEGORIES_PATH = ""
_C.TENSORBOARD.CONFUSION_MATRIX = CfgNode()
_C.TENSORBOARD.CONFUSION_MATRIX.ENABLE = False
_C.TENSORBOARD.CONFUSION_MATRIX.FIGSIZE = [8, 8]
_C.TENSORBOARD.CONFUSION_MATRIX.SUBSET_PATH = ""
_C.TENSORBOARD.HISTOGRAM = CfgNode()
_C.TENSORBOARD.HISTOGRAM.ENABLE = False
_C.TENSORBOARD.HISTOGRAM.FIGSIZE = [8, 8]
_C.TENSORBOARD.HISTOGRAM.SUBSET_PATH = ""
_C.TENSORBOARD.HISTOGRAM.TOPK = 10
# Path to pickled test predictions for offline plotting (`defaults.py:1144`).
_C.TENSORBOARD.PREDICTIONS_PATH = ""
# Model-visualization sweep (`defaults.py:1183-1222`).
_C.TENSORBOARD.MODEL_VIS = CfgNode()
_C.TENSORBOARD.MODEL_VIS.ENABLE = False
_C.TENSORBOARD.MODEL_VIS.MODEL_WEIGHTS = False
_C.TENSORBOARD.MODEL_VIS.ACTIVATIONS = False
_C.TENSORBOARD.MODEL_VIS.INPUT_VIDEO = False
_C.TENSORBOARD.MODEL_VIS.LAYER_LIST = []
_C.TENSORBOARD.MODEL_VIS.TOPK_PREDS = 1
_C.TENSORBOARD.MODEL_VIS.COLORMAP = "Pastel2"
_C.TENSORBOARD.MODEL_VIS.GRAD_CAM = CfgNode()
_C.TENSORBOARD.MODEL_VIS.GRAD_CAM.ENABLE = True
_C.TENSORBOARD.MODEL_VIS.GRAD_CAM.LAYER_LIST = []
_C.TENSORBOARD.MODEL_VIS.GRAD_CAM.USE_TRUE_LABEL = False
_C.TENSORBOARD.MODEL_VIS.GRAD_CAM.COLORMAP = "viridis"
# Wrong-prediction video logging (`defaults.py:1226-1232`).
_C.TENSORBOARD.WRONG_PRED_VIS = CfgNode()
_C.TENSORBOARD.WRONG_PRED_VIS.ENABLE = False
_C.TENSORBOARD.WRONG_PRED_VIS.TAG = "Incorrectly classified videos."
_C.TENSORBOARD.WRONG_PRED_VIS.SUBSET_PATH = ""

# ------------------------------------------------------------------- VIS_MASK
_C.VIS_MASK = CfgNode()
_C.VIS_MASK.ENABLE = False

# ----------------------------------------------------------------------- DEMO
_C.DEMO = CfgNode()
_C.DEMO.ENABLE = False
_C.DEMO.LABEL_FILE_PATH = ""
_C.DEMO.WEBCAM = -1
_C.DEMO.INPUT_VIDEO = ""
_C.DEMO.DISPLAY_WIDTH = 0
_C.DEMO.DISPLAY_HEIGHT = 0
_C.DEMO.BUFFER_SIZE = 0
_C.DEMO.OUTPUT_FPS = -1
_C.DEMO.OUTPUT_FILE = ""
_C.DEMO.CLIP_VIS_SIZE = 10
_C.DEMO.NUM_VIS_INSTANCES = 2
_C.DEMO.THREAD_ENABLE = False
# Person-detector settings (the reference uses Detectron2; accepted for
# config parity — this framework's AVA demo consumes precomputed boxes).
_C.DEMO.DETECTRON2_CFG = "COCO-Detection/faster_rcnn_R_50_FPN_3x.yaml"
_C.DEMO.DETECTRON2_WEIGHTS = (
    "detectron2://COCO-Detection/faster_rcnn_R_50_FPN_3x/137849458/"
    "model_final_280758.pkl"
)
_C.DEMO.DETECTRON2_THRESH = 0.9
_C.DEMO.FPS = 30
_C.DEMO.INPUT_FORMAT = "BGR"
_C.DEMO.NUM_CLIPS_SKIP = 0
_C.DEMO.COMMON_CLASS_NAMES = []
_C.DEMO.SLOWMO = 1
_C.DEMO.VIS_MODE = "thres"
_C.DEMO.COMMON_CLASS_THRES = 0.7
_C.DEMO.UNCOMMON_CLASS_THRES = 0.3
# AVA demo with precomputed boxes (`defaults.py:1284` DEMO.PREDS_BOXES).
_C.DEMO.PREDS_BOXES = ""
_C.DEMO.GT_BOXES = ""
_C.DEMO.STARTING_SECOND = 900

# ------------------------------------------------------------------------ TPU
# TPU-native runtime knobs (new capability, no reference equivalent).
_C.TPU = CfgNode()
_C.TPU.MESH_SHAPE = []  # e.g. [8] or [4, 2]; empty = all local devices on "data"
_C.TPU.MESH_AXES = ["data"]
# Sharding strategy: "dp" pure data parallel (reference DDP equivalent) |
# "dp_sp" adds temporal sequence parallelism over a (data, model) mesh |
# "fsdp" ZeRO-3-style parameter sharding over the data axis.
_C.TPU.SHARD_STRATEGY = "dp"
_C.TPU.COMPUTE_DTYPE = "bfloat16"
_C.TPU.PARAM_DTYPE = "float32"
_C.TPU.COORDINATOR_ADDRESS = ""  # jax.distributed.initialize rendezvous
_C.TPU.PROCESS_ID = -1
_C.TPU.NUM_PROCESSES = -1
_C.TPU.PROFILE_DIR = ""
# Selective activation checkpointing: remat transformer blocks whose input
# token count is >= this value (0 = off). Cheaper than MODEL.ACT_CHECKPOINT
# (all blocks): only the big early-stage grids pay recompute, and their
# activation stash (attention matrices at N~25k) is what blows the HBM
# budget at larger batch sizes.
_C.TPU.REMAT_MIN_SEQ = 0
# Patch-embed conv with spatial stride blocks folded into input channels
# (3 -> sh*sw*3; weights re-embedded exactly, same param tree). Fixes the
# ~4%-efficiency C_in=3 conv lowering: 97.4 -> 93.5 ms/step on v5e.
_C.TPU.FOLD_STEM = True
# Q-tiled (chunked) attention inside XLA: the scores/softmax/@V chain runs
# per q-chunk of this many rows, so no [Nq, Nk] probs buffer is ever
# materialized whole (block1 at bs 8 is 315 MB fwd+bwd). 0 = off. Applies
# to blocks whose Nq exceeds the chunk; exact same math (softmax rows are
# independent). See chunked_attention() in models/attention.py.
_C.TPU.ATTN_Q_CHUNK = 0
# Recompute each chunk's probs in the backward (jax.checkpoint around the
# chunk body) instead of storing them fwd->bwd. Required for the large-
# batch memory win; turn off to measure store-vs-recompute.
_C.TPU.ATTN_CHUNK_REMAT = True
# Hand-written backward for the flat-pool group LayerNorm (standard LN
# gradient via the masked-matmul trick) instead of autodiff through the
# E[x^2] stats chain. Exactness-tested vs autodiff; measured WIN on v5e
# (88.33 -> 87.60 ms/step at bs8, tools/ablate.py flat_ln_vjp, round 4) —
# default on. Only active when MVIT.FLAT_POOLS selects FlatGroupLN.
_C.TPU.FLAT_LN_VJP = True
# Dtype for the fused on-device augmentation chain (RandAugment, erasing,
# color jitter, normalize). The model casts to COMPUTE_DTYPE right after
# preprocessing anyway, so "bfloat16" here only adds sub-quantization noise
# to the (already random) augmentations while halving the aug chain's HBM
# traffic — the step is bandwidth-bound (see ROADMAP). Empty = float32.
_C.TPU.PREPROCESS_DTYPE = ""
# PRNG implementation for the root training key ("" = JAX default,
# threefry2x32). "rbg" routes all in-step randomness (dropout/drop-path,
# RandAugment draws, erasing fill, mixup betas) through the TPU's native
# RngBitGenerator instead of computing threefry rounds on the VPU —
# cheaper bit generation for the aug-heavy train step at the cost of
# stability of the random stream across compiler versions.
_C.TPU.PRNG_IMPL = ""
# Host->device transfer overlap depth: a background thread enqueues the
# device_put/shard of batch N+1 while step N's async dispatch runs (the
# reference hides this in pinned-memory workers + non_blocking copies,
# `MViT/tools/train_net.py:88-111`). 0 = synchronous transfer in the loop;
# N bounds in-flight device input batches (HBM cost: N x input batch).
_C.TPU.DEVICE_PREFETCH = 1


def get_cfg():
    """Return a fresh clone of the default config (+ custom keys,
    `custom_config.py:7-9` extension hook)."""
    from pmv_tpu_torch.config.custom_config import add_custom_config

    cfg = _C.clone()
    add_custom_config(cfg)
    return cfg


def assert_and_infer_cfg(cfg):
    """Validate and derive config values.

    Mirrors `assert_and_infer_cfg` (`MViT/slowfast/config/defaults.py:1327-1364`):
    batch divisibility, BN assertions, and LR scaling by NUM_SHARDS (linear or
    sqrt via BASE_LR_SCALE_NUM_SHARDS).
    """
    # BN assertions.
    if cfg.BN.NORM_TYPE == "sub_batchnorm":
        assert cfg.BN.NUM_SPLITS >= 1

    # TEST assertions.
    assert cfg.TEST.NUM_SPATIAL_CROPS in [1, 3]
    assert cfg.TEST.BATCH_SIZE % max(cfg.NUM_GPUS, 1) == 0

    # TRAIN assertions.
    assert cfg.TRAIN.BATCH_SIZE % max(cfg.NUM_GPUS, 1) == 0

    # Scale LR by the number of shards when requested: linear, or sqrt with
    # BASE_LR_SCALE_NUM_SHARDS_BY_SQRT (reference `defaults.py:1344-1352`).
    if cfg.SOLVER.BASE_LR_SCALE_NUM_SHARDS:
        if cfg.SOLVER.BASE_LR_SCALE_NUM_SHARDS_BY_SQRT:
            factor = math.sqrt(float(cfg.NUM_SHARDS))
        else:
            factor = float(cfg.NUM_SHARDS)
        cfg.SOLVER.BASE_LR *= factor
        cfg.SOLVER.WARMUP_START_LR *= factor
        cfg.SOLVER.COSINE_END_LR *= factor

    # UniFormer fork alias.
    if cfg.SOLVER.CLIP_GRADIENT is not None and cfg.SOLVER.CLIP_GRAD_L2NORM is None:
        cfg.SOLVER.CLIP_GRAD_L2NORM = cfg.SOLVER.CLIP_GRADIENT

    return cfg
