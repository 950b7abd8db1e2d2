#!/usr/bin/env python3
"""Drive the PyTorch port (pmv_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure raises and exits non-zero:

1. Print the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and build every CUDA kernel of the package from its sources.
   nvcc's ptxas report must show no spills.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the MViTv2-S 16x4 path gives it (batch 8, bfloat16 and float32)
   and at odd shapes (C of 8, 24 and 40, H and W of 1, 2, 7 and 13, portrait
   grids, T of 1 to 3, B of 1); time the kernel cold (L2 flushed) and warm,
   the plain version and the one-call library equivalent with CUDA events.
   The forward kernel K1 (``depthwise3x3x3``), then the backward through
   the autograd Function: dx through K1 and dw through
   ``depthwise3x3x3_wgrad``; two runs of the wgrad kernel give the same
   bits. The same at the grids of the PMV rect crop [256, 192] and at their
   transposes (the portrait rows' grids), at batch 8 and at batch 16, the
   clips of run_net's train step in phase 6 (checked against its cfg); and
   at a rank's shapes under dp_sp, 4 + 2 halo planes: the rect crop's and
   their transposes at the batches phase 8e's paths give a rank (2 and 4;
   8e checks that each of its calls is at one of them), and the 224^2
   crop's at batch 8; UniFormer-S's DPE shapes likewise, the rect crop's
   and their transposes at batch 2 and 4 and its 224^2 test crop's at
   batch 4 (``sp_uniformer_*``); X3D-M's channelwise convs on 8 + 2 of its
   16 frames, the rect crop's and their transposes at batch 2 and 4 and
   its 256^2 test crop's at batch 4 (``sp_x3d_*``), and ir-CSN-101's conv_bs
   on half of each stage's planes + 2 at batch 2 (``sp_csn_b2``).
3. Build full-width MViTv2-S 16x4 from a seeded init and run its eval step
   at batch 1 in float32 on the card and on the CPU (the CPU copy takes the
   plain versions); the class scores must agree, and one forward must
   launch the depthwise kernel 17 times.
3b. One train step of full-width MViTv2-S 16x4 (the bench recipe:
   RandAugment, erasing, MixUp/CutMix, DropPath, head dropout, AdamW with
   clipping) in float32 at batch 2 on the card and on the CPU, from the
   same weights and the same draws: loss, grad norm, top-1/top-5, the
   gradients and the updated parameters must agree, and the step must
   launch K1 34 times and the wgrad kernel 17 times.
3c. The portrait (``pm``) steps at full width in float32 at batch 2 (one
   portrait row, one landscape row) with TRAIN_CROP_SIZE_RECT [256, 192]
   and SWITCH_AUTO, card against CPU from the same weights and draws: the
   pm eval step (its landscape row equal to the plain eval step's), then
   the pm train step under phase 3b's gates; one orientation group each,
   so 2 x 17 K1 launches per forward, 2 x 17 wgrad per train step.
4. Serve 4 synthetic videos x 2 temporal views x 3 spatial crops through
   the multi-view test loop in bfloat16 at batch 8 (a main path: launch
   counts are zeroed just before it and read just after).
5. Train: ``train_epoch`` over 1 warm-up and then 2 timed synthetic batches
   of 8 clips [16, 224, 224, 3] uint8, bfloat16 activations, AdamW, LR 1e-4
   (a main path: counts zeroed just before the 2 batches and read just
   after; 34 K1 and 17 wgrad launches per step).
6. ``run_net`` in this process on configs/Kinetics/MVITv2_S_16x4.yaml with
   the PMV rect recipe (exps/PMV/run_MViT_PMV.sh), the Synthetic dataset,
   batch 8 (16 clips a train step: AUG.NUM_SAMPLE 2), bfloat16, one epoch:
   train through the loader and the device prefetcher, checkpoint,
   evaluate, test 2 views (this slice's main path). Prints epoch, eval and
   test clips/s, the checkpoint's seconds and bytes (all read from the
   run's own log and files), peak memory and the final json_stats.
7. The checkpoint restored as ``train()`` restores it, every weight and
   AdamW tensor compared with the file's; then ``run_net`` again with
   SOLVER.MAX_EPOCH 2: its log must show the resume from that checkpoint
   at epoch 2, and its optimizer must count both epochs' steps.
UniFormer-S 16x4 (configs/Kinetics/UNIFORMER_S_16x4.yaml, full width and
depth, 21.4M parameters, random weights from a seed), whose blocks each open
with a DPE conv on K1, 18 a forward:
2u. Phase 2 also holds both kernels at UniFormer's DPE shapes: the 224^2,
   PMV rect and transposed grids, at batch 8 and 16.
3u. Eval at batch 1 and one train step at batch 2 (the config's recipe:
   RandAugment, erasing, MixUp/CutMix, DropPath, AdamW), float32, card
   against CPU under phase 3b's gates, and the BatchNorm running statistics
   to rtol 1e-4; 18 K1 launches a forward, 36 K1 and 18 wgrad a train step.
   Then the pm steps (rect [256, 192], one portrait and one landscape row):
   eval 2 x 18 K1; train 72 K1 and 36 wgrad (BatchNorm's batch statistics
   cross rows, so the step runs the whole batch in both orientations).
4u. Serve 4 videos x 4 temporal views x 1 crop at 224^2 (the recipe's
   test protocol) in bfloat16 at batch 8 (a main path).
5u. Train 2 timed batch-8 bfloat16 steps through ``train_epoch`` (a main
   path).
6u-7u. ``run_net`` on configs/Kinetics/UNIFORMER_S_16x4.yaml with the
   rect 256x192 run of exps/PMV/run_Uniformer_PMV.sh, the Synthetic
   dataset, batch 8 (16 clips a step), one epoch; the restore, every tensor
   (the BatchNorm buffers included) compared; then the resume with
   SOLVER.MAX_EPOCH 2 (main paths).
X3D-M (configs/Kinetics/X3D_M.yaml, full width and depth: 26 blocks,
random weights from a seed), whose 22 stride-1 channelwise convs a forward
run on K1, C = 54 and 108 through the wrappers' channel pad:
2x. Phase 2 also holds both kernels at X3D-M's shapes: the 224^2, PMV
   rect, transposed and 256^2 (test crop) grids at batch 8, and odd shapes
   at C = 12 and 54; where C is padded, the records give the pad's own ms
   beside the wrapper's (pad included), and the pad copies of a layer's
   forward and backward through the autograd Function (each tensor padded
   once) beside the copies of padding each call's inputs apart.
3x. Eval at batch 1 (22 K1 launches) and one train step at batch 2 (the
   config's recipe: SGD with Nesterov momentum, head dropout 0.5; 44 K1 and
   22 wgrad), float32, card against CPU under phase 3b's gates with the
   BatchNorm running statistics, save the gradients and the grad norm: a
   ReLU input within a rounding of 0 decides either way and moves X3D-M's
   whole gradient, so the gradients are held to the fixed limit of
   ``tools/grad_witness.py`` (``RELU_LIMITS``) and the grad norm is only
   printed, and then the card's step again from the same weights, each
   ReLU deciding as on the CPU, both to 1e-4;
   the pm steps (rect [256, 192], one portrait and one landscape row: eval
   2 x 22 K1, train 88 K1 and 44 wgrad), the same way; precise BN over 2
   batches, card against CPU, its statistics under the same gate.
4x. Serve 4 videos x 2 temporal views x the recipe's 3 spatial crops of
   256^2 in bfloat16 at batch 8 (a main path; the views cut from 10 to 2,
   as phase 4 cuts MViT's).
5x. Train 2 timed batch-8 bfloat16 steps at 224^2 through ``train_epoch``
   (a main path).
6x-7x. ``run_net`` on configs/Kinetics/X3D_M.yaml with the rect_256_192
   run of exps/PMV/run_X3D_PMV.sh, the Synthetic dataset, batch 8 (8 clips
   a step), one epoch: train, precise BN (its log line checked), checkpoint,
   eval, test 2 views of 256^2; the restore, every tensor compared; the
   resume with SOLVER.MAX_EPOCH 2 (main paths).
SlowFast 8x8 R50 (configs/Kinetics/SLOWFAST_8x8_R50.yaml, full width and
depth, random weights from a seed; 32 frames, the slow pathway every 4th),
the first of the ResNet family, whose convs are all dense or 1x3x3 (none on
K1: each of its phases asserts 0 K1 and 0 wgrad launches):
3s. Eval at batch 1 and one SGD train step at batch 2 (the config's
   recipe: cross-entropy, head dropout 0.5, SGD with momentum), float32,
   card against CPU under phase 3b's gates with the BatchNorm running
   statistics; the pm steps (rect [256, 192], one portrait and one
   landscape row; the train step runs the whole batch in both
   orientations); precise BN over 2 batches, card against CPU. ReLU
   decisions move SlowFast's float32 gradients as X3D-M's, and float32's
   own floor lies above the 1e-4 gates even with them held
   (``grad_witness.FLOAT64_HELD``): the float32 gradients are held to
   ``RELU_LIMITS``, the held readings and precise BN's float32 statistics
   printed, and each train step (at 8 of the 32 frames) and precise BN
   run again in float64 on card and CPU under every 1e-4 gate.
4s. Serve 4 videos x 2 temporal views x the recipe's 3 spatial crops of
   256^2 in bfloat16 at batch 8 (a main path; the views cut from 10 to 2).
5s. Train 2 timed batch-8 bfloat16 steps at 224^2 through ``train_epoch``
   (a main path).
6s-7s. ``run_net`` on configs/Kinetics/SLOWFAST_8x8_R50.yaml with the
   rect_256_192 data options of exps/PMV/run_X3D_PMV.sh, the Synthetic
   dataset, batch 8, one epoch: train, precise BN, checkpoint, eval, test 2
   views of 256^2; the restore, every tensor compared; the resume with
   SOLVER.MAX_EPOCH 2 (main paths).
AVSlowFast 8x8 R50 (configs/Kinetics/AVSLOWFAST_8x8_R50.yaml, full width
and depth, 38,059,696 parameters with the misaligned audio's AVS
projections, random weights from a seed): SlowFast's trunk, an audio
pathway of 2-D convs over a 128 x 80 log-mel, the audio-to-slow fusions,
the AVS sync losses and DropPathway; no conv on K1 (0 launches asserted):
3v. (Run after 3s.) At batch 1 on 8 of the 32 frames (2 slow) of 224^2 and
   a full log-mel, float32, card against CPU: the eval step; a train step
   with the misaligned audio at DROPPATHWAY_RATE 0 and at 1 (the audio
   fusion kept, then dropped: every AVS loss counts), each AVS loss and the
   loss to rtol 1e-4, the gradients to ``grad_witness.RELU_LIMITS``, the
   update and the BatchNorm statistics; then each step in float64 on both
   sides under every 1e-4 gate (``grad_witness.FLOAT64_HELD``).
4v. Serve 4 videos x 2 views x 3 crops of 256^2, each clip with its
   log-mel, through ``perform_test`` in bfloat16 at batch 8 (a main path).
5v. Train 3 timed batch-8 bfloat16 steps at 32 x 224^2 through
   ``train_epoch``, the batches' misaligned audio rolled into the easy
   negatives, then 2 under the profiler: ms a step, clips/s, the busy
   share, peak memory (a main path).
6v. ``run_net`` on the yaml (NUM_GPUS 1, batch 8) over ``Synthetic_av``,
   a dataset this script registers (``register_synthetic_av``: Synthetic's
   16 videos' clips with log-mels cut as ``Kinetics_av`` cuts them from a
   waveform drawn from the video), one epoch: train, precise BN,
   checkpoint, eval, a 2-view test of 256^2; the restore, every tensor
   compared; the resume with SOLVER.MAX_EPOCH 2 (main paths; log in
   ``build/chip_smoke_run_net_avslowfast/stdout.log``).
ir-CSN-101 32x2 (configs/Kinetics/CSN_32x2_R101.yaml, 22,213,776
parameters: 30 stride-1 depthwise conv_bs a forward on K1) and R(2+1)D-50
16x4 (configs/Kinetics/R2PLUS1D_16x4_R50.yaml, 46,979,120 parameters, 0
K1), full width and depth, random weights from a seed; the image MViTv2-S
(configs/ImageNet/MVITv2_S.yaml); SlowFast 16x8 R50 on Charades:
2n. Phase 2 also holds both kernels at CSN-101's four conv_b shapes at
   batch 8 on 32 x 224^2 (grid "csn") and on the 256^2 test crop that
   serving and run_net's test give K1 (grid "csn_test"), bfloat16 and
   float32.
3n. (Run with phase 3.) CSN-101 at batch 1 on 16 of its 32 frames (the
   CPU reference's time), float32, card against CPU: the eval step (30
   K1), one SGD train step (60 K1, 30 wgrad), the gradients to
   ``grad_witness.RELU_LIMITS["CSN"]`` free and, with the CPU's ReLU
   decisions held, to ``HELD_LIMITS["CSN"]`` (its float32 floor against
   float64 lies above 1e-4), the running statistics to
   ``STATS_LIMITS["CSN"]``; K1 takes no float64, so no float64 rerun.
3r. R(2+1)D-50 the same at batch 1 on its 16 frames (0 K1), then the step
   again in float64 on 8 frames under every 1e-4 gate (``FLOAT64_HELD``).
3i. The image MViTv2-S (PATCH_2D, 1 frame of 224^2, 1000 classes): eval
   and one AdamW step at batch 2 under MViT's 1e-4 gates, 0 K1.
4n-5n. Each of CSN-101 and R(2+1)D-50 serves 4 videos x 2 views x 3 crops
   of 256^2, then trains 3 timed batch-8 bfloat16 steps through
   ``train_epoch`` (main paths), then 2 more under the profiler: ms a step,
   clips/s, peak memory, the device's busy share and K1's and wgrad's
   shares of it.
6n. ``run_net`` on the CSN yaml (Synthetic, batch 8, one epoch: train,
   precise BN, checkpoint, eval, a 2-view test of 256^2), the restore,
   every tensor compared, and the resume with SOLVER.MAX_EPOCH 2 (main
   paths; log in ``build/chip_smoke_run_net_csn/stdout.log``). 6r: one
   ``run_net`` epoch of the R(2+1)D yaml, no resume.
6h. A Charades frame dump from a seed in ``build/chip_smoke_charades/`` (16
   videos of 140 JPEG frames of 340x256, 1-3 of 157 classes a frame), then
   ``run_net`` on configs/Charades/SLOWFAST_16x8_R50.yaml at full width
   (64 frames, bce_logit, 2 views x 3 crops of the test ensembled by max),
   overriding only the data paths, NUM_GPUS 1, batch 8,
   TRAIN.CHECKPOINT_FILE_PATH "", one epoch and the test's views (the
   yaml's 10 cut to 2): the eval epoch's mAP and the test's (a main path,
   0 K1).
AVA action detection (configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml at full
width: SlowFast 32x2 R50 with res5 at stride 1 and dilation 2, the feature
stride 16, RoIAlign 7x7 and the spatial max per pathway, 80 classes on
2048 + 256 channels; ``AVA_PARAMS``, the JAX model's count; random
weights from a seed), on a dump written from a seed (``tools/ava_dump.py``:
8 videos of 90 JPEGs of 455x256, keyframes at seconds 902-904, the
groundtruth, label map and excluded timestamp, so ``AVAMeter`` reads its
groundtruth file); no conv on K1 (0 launches asserted on every phase):
3a. (Run after 3v.) At batch 2 on 8 of the 32 frames (2 slow) of 224^2,
   16 box slots a clip, 3 valid (one at the crop's edge), float32, card
   against CPU: the detection eval step (scores to atol 1e-4, 0 on the
   padded boxes); one detection train step (BCE over the valid boxes,
   head dropout 0.5, SGD) under phase 3s's gates (the gradients to
   ``grad_witness.RELU_LIMITS["SlowFast_AVA"]``, the loss, the update, the
   BatchNorm statistics), then in float64 on both sides under every 1e-4
   gate (``FLOAT64_HELD``).
4a. Serve 4 batches of 8 keyframe clips of 32 x 224^2 (3 boxes each)
   through ``test.perform_detection`` into a test ``AVAMeter`` in bfloat16:
   ms a batch, clips/s, the mAP finite (a main path).
5a. Train 3 timed batch-8 bfloat16 detection steps through ``train_epoch``
   (the boxes through the prefetcher), then 2 under the profiler: ms a
   step, clips/s, peak memory, the busy share (a main path).
6a. ``run_net`` on the dump, on each AVA yaml (NUM_GPUS 1, batch 8, one
   epoch): train, the val epoch's AVA mAP, the checkpoint, ``test()``'s AVA
   mAP; the restore, every tensor compared; the resume with
   SOLVER.MAX_EPOCH 2. SlowFast's first call starts, as the recipe does,
   from a Kinetics SlowFast (configs/Kinetics/SLOWFAST_8x8_R50.yaml's
   model from a seed, 400 classes, a ``.pyth``): the trunk's tensors load,
   the projection keeps its init (main paths; logs in
   ``build/chip_smoke_ava/run_{slowfast,slow}/stdout.log``).
Multigrid training of SlowFast 8x8 R50
(configs/Kinetics/SLOWFAST_8x8_R50_stepwise_multigrid.yaml: long and short
cycles, SubBatchNorm, the BatchNorm swap across cycles; 0 K1 launches):
3g. (Run with phase 3.) SubBatchNorms of 2 splits, one float32 SGD step at
   batch 4, card against CPU under phase 3s's gates (and again in float64
   at 8 frames),
   the split running statistics to rtol 1e-4; then the norms swapped to
   plain BatchNorm and back on both sides: the card's converted statistics
   equal to the same conversion, on the CPU, of the card's own.
4g. The bf16 train step at each of the four long-cycle shapes of the full
   recipe at TRAIN.BATCH_SIZE 8 (64 x 8 x 158^2 sub 8, 32 x 16 x 158^2 sub
   4, 16 x 16 x 224^2 sub 2, 8 x 32 x 224^2 plain), each at its short
   cycle's three batches (up to 128 clips): ms a step, clips/s, peak
   memory (a main path).
6g. ``run_net`` on the recipe cut to 32 Synthetic videos (TRAIN.BATCH_SIZE
   2, BN_BASE_SIZE 2, STEPS [0, 3], MAX_EPOCH 4 before the schedule
   rewrites them: 6 epochs through sub_batchnorm of 8, 4 and 2 splits, then
   batchnorm), bf16: each epoch's shape and BatchNorm type as the schedule
   gives them, precise BN after each, the evaluations of ``is_eval_epoch``,
   a 2-view test; the restore of the checkpoint of epoch 3 (4 splits),
   every tensor compared; that checkpoint alone in a fresh OUTPUT_DIR, from
   which ``run_net`` resumes at epoch 4 (2 splits) and finishes (main
   paths; logs in ``build/chip_smoke_run_net_multigrid{,_resumed}/``).
6p. 6g's first call runs with TPU.PROFILE_DIR: its one trace
   (``build/chip_smoke_profile/``), its bytes, the steps it covers and its
   CUDA kernel events.
6b. ``python -m pmv_tpu_torch.tools.benchmark`` (a process of its own) on
   SlowFast 8x8 R50's yaml, Synthetic, batch 8, one epoch: the loader's
   clips/s and the process's peak RAM (numpy's draws, the loader's threads
   and collate; no decoding).
MaskFeat pre-training of MViTv2-S 16x4
(configs/masked_ssl/k400_MVITv2_S_16x4_MaskFeat_PT.yaml at full width:
16 blocks, 16 frames of 224^2, HOG targets; 36,190,974 parameters, the JAX
model's count; random weights from a seed), whose blocks 14-15 keep the
14 x 14 grid: its 14 stride-1 q-pools a forward run on K1, at shapes phase
2 holds (``MASKFEAT_POOL_SHAPES``):
3m. (Run after 3s, with phase 3.) float32, card against CPU: the forward
   at batch 1 with one mask from a seed (pred to atol 1e-4; the HOG target
   with the CPU's orientation bins held to 1e-5, the card's own target to
   1e-5 on the tokens whose pixels both sides binned alike, the pixels
   binned otherwise counted; 14 K1);
   one AdamW step at batch 2 with the 0.02 clip from the same draws and
   bins: loss and grad norm to 1e-4, weights within 2 x lr, 28 K1 and 14
   wgrad; the gradients to 1e-4 (relative L2) with the card's max pools
   (the skip pools of blocks 1 and 3) taking the CPU's taps, as the bins
   are held (the gradients with the card's own taps, and the taps taken
   otherwise, printed).
4m. The bf16 masked step at batch 8, timed alone: ms a step, clips/s, peak
   memory, K1's and wgrad's launches and their share of the step.
5m. 2 steps of ``train_ssl``'s loop body (``train_epoch`` over the masked
   step) at batch 8 in bfloat16 (a main path).
6m. ``run_net`` on the PT yaml (one process, batch 8, ``Synthetic``: the
   model draws its masks) for one epoch, its checkpoint; the restore as
   ``train_ssl`` makes it, every tensor compared; ``run_net`` again with
   SOLVER.MAX_EPOCH 2, which must resume (main paths; log in
   ``build/chip_smoke_run_net_maskfeat/stdout.log``).
7m. The fine-tuning yaml (configs/masked_ssl/k400_MVITv2_S_16x4_FT.yaml)
   from 6m's checkpoint with CLEAR_NAME_PATTERN ["backbone."]: the load as
   ``train()`` makes it (every FT tensor equal to the checkpoint's
   ``backbone.`` tensor of its name and shape, the rest at their init, no
   optimizer state, epoch 0; the counts printed), then ``run_net`` in
   float32 (4 videos x 2 clips a step, eval, a 1-view test; 17 K1 a
   forward; a main path; log in
   ``build/chip_smoke_run_net_maskfeat_ft/stdout.log``).
VIS_MASK. ``run_net`` with the MAE variant (MASK.PRED_HOG False) at
   TEST.BATCH_SIZE 2: 4 (original | masked | reconstructed) stacks in
   ``build/chip_smoke_vis_mask/`` (a main path).
Contrastive SSL (configs/contrastive_ssl/: MoCo, SimCLR, BYOL, SwAV on
Slow 8x8 R50, full width; random weights from a seed; no conv of Slow R50
is on K1, 0 launches asserted):
3c. (Run with phase 3.) Each yaml's step at batch 2 (2 views a video),
   card against CPU from the same weights, SSL state (a seeded queue and
   bank) and colour draws: its encoder's parameter count equal to the JAX
   model's (``SSL_PARAMS``); MoCo in float32 (the gradients to
   ``grad_witness.RELU_LIMITS["Slow"]``, the readings with the CPU's ReLU
   decisions held printed), then every yaml in float64 on 2 of the 8
   frames (``SSL_FLOAT64_FRAMES``) under the 1e-4 gates: loss, grad norm,
   gradients, the weights' updates, BatchNorm statistics, the momentum
   encoder, the queue and its pointer, the bank.
3cx. A SimCLR ContrastiveModel on X3D-M's backbone (X3D_M.yaml with the
   SimCLR yaml's contrastive options): one float32 step at batch 2, card
   against CPU, the CPU's ReLU decisions held as for X3D-M; 88 K1 and 44
   wgrad launches (two train forwards and their backward).
4c. The MoCo yaml's bf16 step at batch 8 (8 videos of two views), timed
   alone: ms, clips/s, peak memory.
5c. 2 steps of ``train_epoch`` over the MoCo step at batch 8 (a main path).
6c. ``run_net`` on the MoCo yaml (one process, batch 8, ``Synthetic``,
   the kNN monitor each epoch, a 1-view test), the restore as
   ``train_ssl`` makes it (every tensor, the queue, bank and momentum
   encoder among them), ``run_net`` again with SOLVER.MAX_EPOCH 2, which
   must resume; then configs/Kinetics/SLOW_8x8_R50.yaml fine-tunes from
   that checkpoint with CLEAR_NAME_PATTERN ["backbone."] (the head alone at
   its init; train, precise BN, eval, a 1-view test). Main paths; logs in
   ``build/chip_smoke_run_net_{moco,slow_ft}/stdout.log``.
Distributed (``pmv_tpu_torch/parallel/distributed.py``):
8. Print whether ``torch.utils.tensorboard``, matplotlib, cv2 and moviepy
   import. 8a: two ranks over
   gloo sharing the one card (NCCL refuses two ranks on one device; the
   kernels were built in phase 1, the ranks only load them): which
   collectives gloo carries on CUDA tensors; UniFormer-S 16x4 at full width,
   float32, the PMV rect crop, MixUp on, 2 rows a rank, one portrait row on
   rank 0 and none on rank 1 (so every rank takes the select: 72 K1 and 36
   wgrad launches a rank a step); each rank's ``dp`` step against the
   one-process step on the global batch of 4 under phase 3b's gates; then
   2 timed steps a rank (a main path): the 2-rank step's ms. 8c: ``run_net``
   as a user launches it on 2 hosts, ``--num_shards 2 --shard_id 0|1
   --init_method`` with NUM_GPUS 1 and gloo, both processes on the one card:
   UniFormer-S's rect recipe in float32 for one epoch (``launch_job``,
   ``train()`` with ``dp``, the gathered eval, the checkpoint written by rank
   0, the gathered test; 16 Synthetic videos), its test_final against one
   process's at twice a process's batch, then a resume (main paths, counted
   in each rank's process); its first 3 processes start with 8e's
   ``run_net`` pairs', and 8d's ranks run beside them. 8b: a world
   of one over NCCL: MViTv2-S at batch 8, the ``dp``
   and the ``fsdp`` step against the unwrapped step under phase 3b's gates
   in float32, and in bfloat16 within BF16_WRAPPER_LIMIT beside a second
   unwrapped run's reading (atomic sums make bfloat16 gradients differ from
   run to run), then 5 timed steps of each (main paths): the wrappers'
   overhead in ms. 8d: 2 ranks over gloo on the one card, the SSL steps
   under ``dp``: MoCo and SimCLR at full width (2 videos of 2 views a
   rank) in float64 activations (Slow R50's ReLUs decide with float32's
   rounding), MaskFeat with loader masks of unequal counts on the two ranks
   in float32, its skip max pools taking the one-process step's taps; each
   rank against the one-process step on the global batch of 4 under phase
   3b's gates, the SSL state to 1e-5. 8f: a world of one over NCCL, the
   SSL steps under ``fsdp``: MoCo on Slow R50 (the momentum encoder
   sharded as the online one, its key forwards through FSDP's gathers) and
   MaskFeat PT (14 K1 a forward), each against the unwrapped step from the
   same seeded init, float32 at batch 2 under phase 3b's gates with the SSL
   state to 1e-5, bfloat16 at batch 8 within BF16_WRAPPER_LIMIT, then 3
   timed steps of each (main paths): the wrapper's overhead in ms.
   8e: every classification model under TPU.SHARD_STRATEGY dp_sp
   (temporal sequence parallelism, ``parallel/mesh.py``) in one spawn of 2
   ranks over gloo on the one card, a grid of data 1 x model 2: full width
   and depth, float32, a global batch of 2 that both ranks hold, each
   rank half of its planes. MViTv2-S 16x4 (16 frames of the PMV rect
   crop, the bench recipe; 17 K1, 17 dx and 17 wgrad a rank a step on
   4 + 2 halo planes), UniFormer-S 16x4 (the rect 256x192 run of
   exps/PMV/run_Uniformer_PMV.sh: 18 each), X3D-M (the rect_256_192 run of
   exps/PMV/run_X3D_PMV.sh: 22 each on 8 + 2 planes, C 54 and 108 through
   the pad), SlowFast 8x8 R50 (32 frames of 224^2: 16 fast and 4 slow a
   rank), ir-CSN-101 32x2 (30 each on 16, 8, 4 and 2 planes + 2),
   R(2+1)D-50 16x4 and AVSlowFast 8x8 R50 (its log-mel audio whole on
   each rank); each rank's eval scores (atol 1e-4) and train step against
   one process on the card (phase 3b's gates for MViT and UniFormer; the
   ReLU nets free to ``RELU_LIMITS``, then X3D-M and CSN with the one
   process's ReLU decisions and the others in float64 on 8 frames, as
   their card-against-CPU phases hold them); BatchNorm's statistics over
   both ranks' planes held to one process's; 3 timed bf16 steps a rank (a
   main path) beside one process's, and the bytes its halos, gathers and
   reductions hand to all_reduce a step (files in
   ``build/chip_smoke_sequence_parallel/``). Then ``run_net --num_shards 2
   TPU.SHARD_STRATEGY dp_sp`` on MViT's, UniFormer's (its 224^2 test crop)
   and X3D-M's (its 256^2 test crop) rect recipes in float32 (16 Synthetic
   videos, 4 a step), each against one process under 8c's gates, their 9
   processes and 8c's first 3 started at once (every process's log in
   ``build/chip_smoke_sequence_parallel_run_net/``).
   ``--plant-wrapper-faults`` logs 8b's readings with faults planted in
   the wrappers instead of running the phases.
Visualization, the demos and 2D->3D inflation, in this process;
the card's host has neither matplotlib nor moviepy, nor FFmpeg, so the
demos read seeded frames from memory and hand theirs to a sink in memory
(``FrameSource``, ``FrameSink``), and no phase asks for a confusion matrix
or a video:
9a. Grad-CAM (``visualization/gradcam.py``) of full-width MViTv2-S 16x4
   on phase 6's checkpoint (its rect crop), float32 at batch 2, card
   against CPU: maps and scores to atol 1e-4, one forward's 17 K1 and no
   wgrad (the gradient stops at the tap).
9b. ``run_net`` on configs/Kinetics/MVITv2_S_16x4.yaml (phase 6's options)
   with TRAIN.ENABLE and TEST.ENABLE False, TENSORBOARD.ENABLE, MODEL_VIS
   (MODEL_WEIGHTS, GRAD_CAM, INPUT_VIDEO) and WRONG_PRED_VIS on 16
   Synthetic videos and phase 6's checkpoint (a main path): a weight
   histogram of every parameter in its event file, 17 K1 a test batch;
   ``plot_eval`` raises where matplotlib is absent.
9c. The demo (``visualization/demo.py``) on MViTv2-S (the yaml, random
   weights from its seed, float32) over 150 seeded frames of 320x240 in
   memory, DEMO.BUFFER_SIZE 8, NUM_CLIPS_SKIP 1, its drawing pool in
   process and with 2 spawned workers (a main path): 150 frames out of
   each, equal; each predicted window's scores equal to the eval step's on
   the same clip; 17 K1 a predicted window.
9d. The AVA demo (``visualization/ava_demo.py``) on SlowFast 32x2 R50 AVA
   (phase 6a's checkpoint) over 90 seeded frames of 455x256 at 30 fps and a
   seeded DEMO.PREDS_BOXES file (a main path): each keyframe's box scores
   equal to the detection eval step's, 90 frames out, 0 K1.
9e. UniFormer-S 16x4 from a seeded image checkpoint in the reference's
   layout (every conv 2-D, 1000 classes, under ``build/chip_smoke_m19/
   pretrained/``) through the pretrain registry (UNIFORMER.PRETRAIN_NAME
   uniformer_small_in1k, PMV_PRETRAIN_ROOT): the card's load equal to the
   CPU's bit for bit, the head and BatchNorm statistics at their init; the
   f32 eval card against CPU (atol 1e-4, 18 K1); 2 bf16 batch-8 steps
   through ``train_epoch`` (a main path; 18 K1, 18 dx, 18 wgrad a step).
10. Print the script's wall time, the kernels line, the card line, and
   last {"ok": true, "device": {...}}.

FFmpeg's development files are not on the card's machine, so no phase
decodes video there; ``run_net`` reads the Synthetic dataset (16 videos in
the earlier slices' phases 6-7, 6u-7u, 6x-7x, 6s-7s, 6m-7m, 6c, 8c and
8e, and with log-mel audio in 6v; 32 in 6g, ``synthetic_videos``; its 64
elsewhere), and 6h and 6a JPEG frames it writes.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

import argparse
import contextlib
import copy
import functools
import json
import os
import re
import shutil
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM data sheet: HBM rate, and the float32 rate outside the tensor
# cores (the depthwise kernel accumulates in float32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

TOLERANCE = {  # (atol, rtol) against the plain version in float32
    torch.float32: (1e-5, 1e-5),
    torch.bfloat16: (1e-2, 8e-3),  # one bfloat16 rounding of the output
}
# dw sums up to B*T*H*W = 393,216 products of N(0, 1) values (of order
# sqrt(393,216) ~ 630) in another order than the plain version's float32
# sums; in bfloat16, one rounding of the output besides.
WGRAD_TOLERANCE = {
    torch.float32: (2e-3, 1e-5),
    torch.bfloat16: (1e-2, 8e-3),
}
TRAIN_LR = 1e-4  # bench.py's learning rate
# Launches timed (median) in phase 2 of the kernel warm, of the plain
# version and of the library call; the kernel cold (L2 flushed), the time
# reported, takes time_ms's 25. Fewer launches of the others keep the
# script's wall time under 600 s.
COMPARE_ITERS = 10
# DATA.TRAIN_CROP_SIZE_RECT of exps/PMV/run_MViT_PMV.sh and of
# exps/PMV/run_Uniformer_PMV.sh's rect_256_192 run.
PMV_RECT = (256, 192)
ROOT = os.path.dirname(os.path.abspath(__file__))
MVIT_CFG = os.path.join(ROOT, "configs", "Kinetics", "MVITv2_S_16x4.yaml")
UNIFORMER_CFG = os.path.join(ROOT, "configs", "Kinetics", "UNIFORMER_S_16x4.yaml")
X3D_CFG = os.path.join(ROOT, "configs", "Kinetics", "X3D_M.yaml")
SLOWFAST_CFG = os.path.join(ROOT, "configs", "Kinetics", "SLOWFAST_8x8_R50.yaml")
# K1 launches in one forward: MViTv2-S's stride-1 pools, UniFormer-S's DPEs,
# X3D-M's stride-1 channelwise convs; SlowFast has none.
MVIT_K1 = 17
UNIFORMER_K1 = 18
X3D_K1 = 22
SLOWFAST_K1 = 0
# AVSlowFast 8x8 R50 (the audio pathway's convs are 2-D: none on K1).
AVSLOWFAST_CFG = os.path.join(ROOT, "configs", "Kinetics", "AVSLOWFAST_8x8_R50.yaml")
AVSLOWFAST_K1 = 0
AVSLOWFAST_PARAMS = 38_059_696  # the JAX model's, with the misaligned audio
AVSLOWFAST_CPU_FRAMES = 8  # the card-against-CPU phase's frames (of the yaml's 32)
X3D_LR = 0.05  # SOLVER.BASE_LR of exps/PMV/run_X3D_PMV.sh
# MaskFeat pre-training of MViTv2-S 16x4, and the fine-tuning from it.
MASKFEAT_PT_CFG = os.path.join(ROOT, "configs", "masked_ssl", "k400_MVITv2_S_16x4_MaskFeat_PT.yaml")
MASKFEAT_FT_CFG = os.path.join(ROOT, "configs", "masked_ssl", "k400_MVITv2_S_16x4_FT.yaml")
MASKFEAT_K1 = 14  # the PT yaml's stride-1 q-pools: blocks 0, 2 and 4-15
MASKFEAT_FT_K1 = 17  # the FT yaml's MViT pools as MViTv2-S does
MASKFEAT_PARAMS = 36_190_974  # the JAX MaskMViT's count (tests/test_torch_port_masked.py)
MASKFEAT_BATCH = 8  # clips a bf16 step (phases 4m-6m)
# Slow 8x8 R50, the contrastive yamls' backbone, and its supervised yaml.
SLOW_CFG = os.path.join(ROOT, "configs", "Kinetics", "SLOW_8x8_R50.yaml")
SLOW_K1 = 0  # Slow R50's convs: none is a stride-1 3x3x3 depthwise conv
# ir-CSN-101 and R(2+1)D-50 (the ported PyTorchVideo recipes), the image
# MViTv2-S on ImageNet, and SlowFast 16x8 R50 on Charades.
CSN_CFG = os.path.join(ROOT, "configs", "Kinetics", "CSN_32x2_R101.yaml")
R2PLUS1D_CFG = os.path.join(ROOT, "configs", "Kinetics", "R2PLUS1D_16x4_R50.yaml")
IMAGENET_MVIT_CFG = os.path.join(ROOT, "configs", "ImageNet", "MVITv2_S.yaml")
CHARADES_CFG = os.path.join(ROOT, "configs", "Charades", "SLOWFAST_16x8_R50.yaml")
CSN_K1 = 30  # the stride-1 conv_bs: 3 + 3 + 22 + 2
R2PLUS1D_K1 = 0  # its conv_b is factored into 1x3x3 and 3x1x1 convs
IMAGENET_MVIT_K1 = 0  # its pools are 1x3x3
CSN_CPU_FRAMES = 16  # the card-against-CPU steps' frames (of the yaml's 32)


def step_launches(per_forward):
    """K1 and wgrad launches of one train step: forward, dx and dw."""
    return {"depthwise3x3x3": 2 * per_forward, "depthwise3x3x3_wgrad": per_forward}


def eval_launches(per_forward):
    return {"depthwise3x3x3": per_forward, "depthwise3x3x3_wgrad": 0}


_LOG_LOCK = threading.Lock()  # phase 8d logs from a thread of its own


def log(msg):
    with _LOG_LOCK:
        print(msg, flush=True)


def float32_without_tf32():
    """float32 convs and matmuls in float32, not TF32 (cuDNN's convs take
    TF32 by PyTorch's default): the card-against-CPU gates hold float32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def depthwise_bound(shape, dtype):
    """Least time (ms) of one stride-1 3x3x3 depthwise conv: bytes (x and w
    read once, out written once) over HBM rate, or 27 FMAs per output over
    the float32 rate, whichever is larger."""
    elems = int(np.prod(shape))
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * elems + 27 * shape[-1]) * size
    ops = 54 * elems
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def wgrad_bound(shape, dtype):
    """Least time (ms) of one depthwise weight gradient: bytes (x and g read
    once, 27 * C float32 written) over HBM rate, or 27 FMAs per input
    element over the float32 rate, whichever is larger."""
    elems = int(np.prod(shape))
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * elems * size + 27 * shape[-1] * 4
    ops = 54 * elems
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _orientation(shape):
    return "square" if shape[2] == shape[3] else "rect" if shape[2] > shape[3] else "portrait"


def _kernel_cases():
    """(shape, launches per forward, grid set): the MViTv2-S 16x4 pool shapes
    at batch 8 at the 224^2 crop ("square"), at the PMV rect crop ("rect")
    and transposed ("portrait"), the last two at run_net's train batch of
    16 ("rect_b16", "portrait_b16"); a rank's under dp_sp on 4 + 2 halo
    planes, at the rect crop and transposed at the batches phase 8e's paths
    give a rank ("sp_rect_b2", "sp_portrait_b2", "sp_rect_b4",
    "sp_portrait_b4") and at the 224^2 crop at batch 8 ("sp_square_b8"), and
    UniFormer-S 16x4's DPE shapes likewise ("sp_uniformer_rect_b2" ...
    "sp_uniformer_portrait_b4"), and at its 224^2 test crop at batch 4
    ("sp_uniformer_square_b4"), X3D-M's channelwise-conv shapes likewise
    on 8 + 2 of its 16 frames ("sp_x3d_rect_b2" ... "sp_x3d_portrait_b4",
    and its 256^2 test crop's at batch 4, "sp_x3d_square_b4"), and
    ir-CSN-101's conv_b shapes at batch 2 on 32 x 224^2, half of each
    stage's planes and 2 halo planes ("sp_csn_b2"); UniFormer-S 16x4's DPE
    shapes on the
    same grids at batch 8 and 16 ("uni_square" ... "uni_portrait_b16");
    X3D-M's channelwise-conv shapes at batch 8 ("x3d_square", "x3d_rect",
    "x3d_portrait", "x3d_test" at 256^2), ir-CSN-101's conv_b shapes at
    batch 8 on 32 x 224^2 ("csn") and on its 256^2 test crop ("csn_test");
    then the odd shapes, and those whose C the wrappers pad
    ("padded_odd")."""
    from pmv_tpu_torch.ops.depthwise import (
        MVIT_POOL_SHAPES,
        MVIT_PORTRAIT_POOL_SHAPES,
        MVIT_RECT_POOL_SHAPES,
        MVIT_RECT_TRAIN_POOL_SHAPES,
        MVIT_SP_POOL_SHAPES,
        MVIT_SP_SQUARE_POOL_SHAPES,
        ODD_SHAPES,
        PADDED_ODD_SHAPES,
        PMV_TRAIN_BATCH,
        UNIFORMER_DPE_SHAPES,
        UNIFORMER_PORTRAIT_DPE_SHAPES,
        UNIFORMER_RECT_DPE_SHAPES,
        UNIFORMER_SP_DPE_SHAPES,
        UNIFORMER_SP_TEST_DPE_SHAPES,
        UNIFORMER_TRAIN_DPE_SHAPES,
        X3D_DW_SHAPES,
        X3D_PORTRAIT_DW_SHAPES,
        X3D_RECT_DW_SHAPES,
        X3D_SP_DW_SHAPES,
        X3D_SP_TEST_DW_SHAPES,
        X3D_TEST_DW_SHAPES,
        CSN_DW_SHAPES,
        CSN_SP_DW_SHAPES,
        CSN_TEST_DW_SHAPES,
    )

    uniformer = (UNIFORMER_DPE_SHAPES + UNIFORMER_RECT_DPE_SHAPES
                 + UNIFORMER_PORTRAIT_DPE_SHAPES + UNIFORMER_TRAIN_DPE_SHAPES)
    return (
        [(s, n, "square") for s, n in MVIT_POOL_SHAPES]
        + [(s, n, "rect") for s, n in MVIT_RECT_POOL_SHAPES]
        + [(s, n, "portrait") for s, n in MVIT_PORTRAIT_POOL_SHAPES]
        + [(s, n, _orientation(s) + "_b16") for s, n in MVIT_RECT_TRAIN_POOL_SHAPES]
        + [(s, n, f"sp_{_orientation(s)}_b{s[0]}")
           for s, n in MVIT_SP_POOL_SHAPES + MVIT_SP_SQUARE_POOL_SHAPES]
        + [(s, n, f"sp_uniformer_{_orientation(s)}_b{s[0]}")
           for s, n in UNIFORMER_SP_DPE_SHAPES + UNIFORMER_SP_TEST_DPE_SHAPES]
        + [(s, n, f"sp_x3d_{_orientation(s)}_b{s[0]}")
           for s, n in X3D_SP_DW_SHAPES + X3D_SP_TEST_DW_SHAPES]
        + [(s, n, "sp_csn_b2") for s, n in CSN_SP_DW_SHAPES]
        + [(s, n, "uni_" + _orientation(s) + ("_b16" if s[0] == PMV_TRAIN_BATCH else ""))
           for s, n in uniformer]
        + [(s, n, "x3d_" + g) for shapes, g in (
            (X3D_DW_SHAPES, "square"), (X3D_RECT_DW_SHAPES, "rect"),
            (X3D_PORTRAIT_DW_SHAPES, "portrait"), (X3D_TEST_DW_SHAPES, "test"))
           for s, n in shapes]
        + [(s, n, "csn") for s, n in CSN_DW_SHAPES]
        + [(s, n, "csn_test") for s, n in CSN_TEST_DW_SHAPES]
        + [(s, 0, "odd") for s in ODD_SHAPES]
        + [(s, 0, "padded_odd") for s in PADDED_ODD_SHAPES]
    )


def pad_ms(shape, pads, slices, dtype, flush):
    """Device ms of channel-pad copies at the C of ``shape`` (0 where C needs
    none): a tensor of each shape in ``pads`` padded with zeros to the
    kernels' channel multiple, and a padded one of each shape in ``slices``
    sliced back to C."""
    import torch.nn.functional as F

    from pmv_tpu_torch.ops.depthwise import CHANNEL_MULTIPLE
    from pmv_tpu_torch.tools.timing import time_ms

    c = shape[-1]
    pad = -c % CHANNEL_MULTIPLE
    if pad == 0:
        return 0.0
    ins = [torch.zeros(s, dtype=dtype, device="cuda") for s in pads]
    outs = [torch.zeros((*s[:-1], c + pad), dtype=dtype, device="cuda") for s in slices]
    return time_ms(lambda: ([F.pad(t, (0, pad)) for t in ins],
                            [t[..., :c].contiguous() for t in outs]), flush=flush)


def phase_kernels(flush):
    import torch.nn.functional as F

    from pmv_tpu_torch.ops.depthwise import depthwise3x3x3, depthwise3x3x3_plain
    from pmv_tpu_torch.tools.timing import time_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for shape, per_forward, grid in _kernel_cases():
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (0.1 * torch.randn((3, 3, 3, shape[-1]), generator=gen,
                                   device="cuda")).to(dtype)
            out = depthwise3x3x3(x, w)
            torch.cuda.synchronize()
            ref = depthwise3x3x3_plain(x.float(), w.float())
            atol, rtol = TOLERANCE[dtype]
            torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)
            err = float((out.float() - ref).abs().max())
            c = shape[-1]
            x_ncdhw = x.permute(0, 4, 1, 2, 3).contiguous()
            w_conv = w.permute(3, 0, 1, 2).reshape(c, 1, 3, 3, 3).contiguous()
            bound_ms, bound_by = depthwise_bound(shape, dtype)
            rec = {
                "kernel": "depthwise3x3x3",
                "grid": grid,
                "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "launches_per_forward": per_forward,
                "max_abs_err": err,
                "kernel_ms": time_ms(lambda: depthwise3x3x3(x, w), flush=flush),
                "kernel_warm_ms": time_ms(lambda: depthwise3x3x3(x, w), COMPARE_ITERS),
                "plain_ms": time_ms(lambda: depthwise3x3x3_plain(x, w), COMPARE_ITERS,
                                    flush=flush),
                "library_ms": time_ms(
                    lambda: F.conv3d(x_ncdhw, w_conv, padding=1, groups=c), COMPARE_ITERS,
                    flush=flush,
                ),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "pad_ms": pad_ms(shape, (shape, w.shape), (shape,), dtype, flush),
            }
            log(json.dumps(rec))
            records.append(rec)
    return records


def phase_backward(flush):
    """The autograd Function's dx (K1 on the cotangent, weights flipped) and
    dw (the wgrad kernel) against the plain versions in float32."""
    from pmv_tpu_torch.ops.depthwise import (
        depthwise3x3x3,
        depthwise3x3x3_plain,
        depthwise3x3x3_wgrad,
        depthwise3x3x3_wgrad_plain,
    )
    from pmv_tpu_torch.tools.timing import time_ms

    gen = torch.Generator(device="cuda").manual_seed(1)
    records = []
    for shape, per_forward, grid in _kernel_cases():
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (0.1 * torch.randn((3, 3, 3, shape[-1]), generator=gen,
                                   device="cuda")).to(dtype)
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            depthwise3x3x3(xg, wg).backward(g)
            torch.cuda.synchronize()
            dx_ref = depthwise3x3x3_plain(g.float(), w.float().flip(0, 1, 2))
            dw_ref = depthwise3x3x3_wgrad_plain(x.float(), g.float())
            atol, rtol = TOLERANCE[dtype]
            torch.testing.assert_close(xg.grad.float(), dx_ref, atol=atol, rtol=rtol)
            atol, rtol = WGRAD_TOLERANCE[dtype]
            torch.testing.assert_close(wg.grad.float(), dw_ref, atol=atol, rtol=rtol)
            if not torch.equal(depthwise3x3x3_wgrad(x, g), depthwise3x3x3_wgrad(x, g)):
                raise AssertionError("the wgrad kernel is not deterministic")
            c = shape[-1]
            x_ncdhw = x.permute(0, 4, 1, 2, 3).contiguous()
            g_ncdhw = g.permute(0, 4, 1, 2, 3).contiguous()
            w_conv = w.permute(3, 0, 1, 2).reshape(c, 1, 3, 3, 3).contiguous()
            bound_ms, bound_by = wgrad_bound(shape, dtype)
            rec = {
                "kernel": "depthwise3x3x3_wgrad",
                "grid": grid,
                "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "launches_per_forward": per_forward,
                "dx_max_abs_err": float((xg.grad.float() - dx_ref).abs().max()),
                "max_abs_err": float((wg.grad.float() - dw_ref).abs().max()),
                "dw_max_abs": float(dw_ref.abs().max()),
                "kernel_ms": time_ms(lambda: depthwise3x3x3_wgrad(x, g), flush=flush),
                "kernel_warm_ms": time_ms(lambda: depthwise3x3x3_wgrad(x, g), COMPARE_ITERS),
                "plain_ms": time_ms(lambda: depthwise3x3x3_wgrad_plain(x, g), COMPARE_ITERS,
                                    flush=flush),
                "library_ms": time_ms(
                    lambda: torch.ops.aten.convolution_backward(
                        g_ncdhw, x_ncdhw, w_conv, None, [1, 1, 1], [1, 1, 1],
                        [1, 1, 1], False, [0, 0, 0], c, [False, True, False],
                    ), COMPARE_ITERS,
                    flush=flush,
                ),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "pad_ms": pad_ms(shape, (shape, shape), (w.shape,), dtype, flush),
                # The pad copies of a layer's forward and backward through
                # the autograd Function: x, w and the cotangent padded once,
                # the output, dx and dw sliced back; beside them the copies
                # of padding each call's inputs apart (x and w, the
                # cotangent and the flipped w, x and the cotangent).
                "step_pad_ms": pad_ms(shape, (shape, w.shape, shape), (shape, shape, w.shape),
                                      dtype, flush),
                "step_pad_ms_padded_per_call": pad_ms(
                    shape, (shape, w.shape, shape, w.shape, shape, shape),
                    (shape, shape, w.shape), dtype, flush),
            }
            log(json.dumps(rec))
            records.append(rec)
    return records


def phase_full_model(cfg, frames, per_forward, phase="full_model_f32_b1", audio=None):
    """The eval step of the full model at batch 1 in float32, card against
    CPU (AVSlowFast's with ``audio``): scores to atol 1e-4, ``per_forward``
    K1 launches."""
    from pmv_tpu_torch.engine.steps import make_eval_step

    cpu_model, gpu_model = _models_card_and_cpu(cfg)
    n_params = sum(p.numel() for p in gpu_model.parameters())

    before = _launch_counts()
    t0 = time.perf_counter()
    gpu = make_eval_step(cfg, gpu_model, device="cuda")(frames, audio=audio).cpu()
    gpu_s = time.perf_counter() - t0
    launches = _launches_since(before)
    t0 = time.perf_counter()
    cpu = make_eval_step(cfg, cpu_model, device="cpu")(frames, audio=audio)
    cpu_s = time.perf_counter() - t0
    err = float((gpu - cpu).abs().max())
    log(json.dumps({
        "phase": phase, "model": cfg.MODEL.MODEL_NAME, "params": n_params,
        "depthwise_launches": launches["depthwise3x3x3"], "max_abs_err_vs_cpu": err,
        "gpu_first_call_s": gpu_s, "cpu_s": cpu_s,
    }))
    if launches != eval_launches(per_forward):
        raise AssertionError(f"one forward launched {launches}, not {per_forward} K1")
    if not torch.isfinite(gpu).all():
        raise AssertionError("non-finite class scores on the card")
    torch.testing.assert_close(gpu, cpu, atol=1e-4, rtol=0)


def _train_cfg(tiny=False):
    from pmv_tpu_torch.entry import apply_bench_recipe, mvitv2_s_cfg

    cfg = apply_bench_recipe(mvitv2_s_cfg(tiny))
    cfg.SOLVER.BASE_LR = TRAIN_LR
    return cfg


def uniformer_cfg():
    """UniFormer-S 16x4 with its config's recipe (RandAugment, erasing,
    MixUp/CutMix, DropPath 0.1, AdamW) at LR 1e-4, and the PMV recipe's
    test protocol (exps/PMV/run_Uniformer_PMV.sh: 4 views, 1 crop, 224^2);
    no pretrained weights (UNIFORMER.PRETRAIN_NAME "")."""
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(UNIFORMER_CFG)
    cfg.UNIFORMER.PRETRAIN_NAME = ""
    cfg.TENSORBOARD.ENABLE = False
    cfg.SOLVER.BASE_LR = TRAIN_LR
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 4
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    cfg.DATA.TEST_CROP_SIZE = 224
    return cfg


def x3d_cfg():
    """X3D-M with its config's recipe (SGD with Nesterov momentum, head
    dropout 0.5) at the PMV recipe's LR (``X3D_LR``), and its test protocol
    of 3 crops of 256^2 with the views cut from 10 to 2."""
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(X3D_CFG)
    cfg.SOLVER.BASE_LR = X3D_LR
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    return cfg


def slowfast_cfg():
    """SlowFast 8x8 R50 with its config's recipe (cross-entropy, head
    dropout 0.5, SGD with momentum) at the PMV X3D recipe's LR (``X3D_LR``:
    no PMV recipe is published for SlowFast), and its test protocol of 3
    crops of 256^2 with the views cut from 10 to 2."""
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(SLOWFAST_CFG)
    cfg.SOLVER.BASE_LR = X3D_LR
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    return cfg


def csn_cfg(path=CSN_CFG):
    """ir-CSN-101 32x2 (or, given its yaml, R(2+1)D-50 16x4) with its
    recipe (SGD with Nesterov momentum, head dropout 0.5, LR 0.1), and its
    test protocol of 3 crops of 256^2 with the views cut from 10 to 2."""
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(path)
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    return cfg


def imagenet_mvit_cfg():
    """The image MViTv2-S (PATCH_2D, 1 frame of 224^2, 1000 classes) with its
    recipe (RandAugment, MixUp/CutMix, AdamW with clipping)."""
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(IMAGENET_MVIT_CFG)
    return cfg


@contextlib.contextmanager
def synthetic_videos(n):
    """Within the block, the Synthetic dataset holds ``n`` videos (its
    ``NUM_VIDEOS``, the JAX package's 64 outside): the run_net epochs of
    the earlier slices' paths at 16 (32 before the AVA phases came) keep
    the script's wall time near 600 s."""
    from pmv_tpu_torch.data.synthetic import Synthetic

    before = Synthetic.NUM_VIDEOS
    Synthetic.NUM_VIDEOS = n
    try:
        yield
    finally:
        Synthetic.NUM_VIDEOS = before


EARLIER_RUN_NET_VIDEOS = 16
# The float64 reruns' frames, evenly strided from the batch's: the
# supervised steps' (SlowFast's 32, R(2+1)D's 16) and the contrastive
# steps' (Slow's 8). The same gates at a fraction of the CPU's float64 time.
FLOAT64_FRAMES = 8
SSL_FLOAT64_FRAMES = 2
# 6g's Synthetic videos: the schedule visits every BatchNorm type and epoch
# shape as on 64, each epoch in half the steps (1 to 6 of them).
MULTIGRID_VIDEOS = 32


def _fewer_frames(frames, t):
    """``t`` frames of ``frames`` (time on axis -4: [B, T, H, W, C] or
    [B, V, T, H, W, C]), every (T // t)-th from the first."""
    every = slice(None, None, frames.shape[-4] // t)
    return frames[(slice(None),) * (frames.ndim - 4) + (every,)]


def _launch_counts():
    from pmv_tpu_torch.ops.depthwise import depthwise3x3x3, depthwise3x3x3_wgrad

    return {"depthwise3x3x3": depthwise3x3x3.launches,
            "depthwise3x3x3_wgrad": depthwise3x3x3_wgrad.launches}


def _zero_launch_counts():
    from pmv_tpu_torch.ops.depthwise import depthwise3x3x3, depthwise3x3x3_wgrad

    depthwise3x3x3.launches = depthwise3x3x3_wgrad.launches = 0


def _launches_since(before):
    return {k: v - before[k] for k, v in _launch_counts().items()}


_SEEDED = {}  # (config, dtype) -> the CPU model of build_model(..., seed=0)


def seeded_model(cfg, device, dtype=None):
    """``build_model(cfg, device, dtype, seed=0)``: a copy of that model,
    whose seeded init (drawn on the CPU, seconds at full width) is drawn
    once for each config and dtype; the phases build the same ones again
    and again."""
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.models.build import compute_dtype

    dtype = compute_dtype(cfg) if dtype is None else dtype
    key = (cfg.dump(), dtype)
    if key not in _SEEDED:
        _SEEDED[key] = build_model(cfg, device="cpu", dtype=dtype, seed=0)
    return copy.deepcopy(_SEEDED[key]).to(device)


def _models_card_and_cpu(cfg, dtype=torch.float32):
    """Models from one seeded init, on the CPU and on the card, computing in
    ``dtype`` (float32 weights)."""
    return seeded_model(cfg, "cpu", dtype), seeded_model(cfg, "cuda", dtype)


def _running_stats(model):
    return {k: v.detach().cpu() for k, v in model.named_buffers() if "running" in k}


def _running_stats_err(gpu_model, cpu_model):
    """BatchNorm running statistics, card against CPU: (the largest
    difference beyond rtol 1e-4, the largest difference), 0 without
    BatchNorm. An entry near 0 may differ by 1e-6 at most (a running mean
    is 0.1 x a batch mean, which may be any small number)."""
    return _stats_err(_running_stats(gpu_model), _running_stats(cpu_model))


def _stats_err(got, want):
    over = max((float(((got[k] - v).abs() - 1e-4 * v.abs()).max())
                for k, v in want.items()), default=0.0)
    diff = max((float((got[k] - v).abs().max()) for k, v in want.items()), default=0.0)
    return over, diff


def _grads(model):
    return {k: p.grad.detach().cpu() for k, p in model.named_parameters()}


def _grad_rel_err(grads, ref):
    """Relative L2 distance of all of ``grads`` from all of ``ref``."""
    diff = sum(float((grads[k] - v).square().sum()) for k, v in ref.items())
    return (diff / sum(float(v.square().sum()) for v in ref.values())) ** 0.5


def _train_step_card_vs_cpu(phase, cfg, batch, expected, models=None, dtype=torch.float32):
    """One train step at cfg.SOLVER.BASE_LR on the card and on the CPU from
    the same weights and draws, activations in ``dtype``; raises unless they
    agree and the card's step launched ``expected``. The gradients (relative
    L2) and the grad norm are held to 1e-4; for a model in
    ``grad_witness.RELU_LIMITS`` (X3D-M, SlowFast, CSN, R(2+1)D; the key
    ``witness_key``) in float32 the gradients to its limit and the grad
    norm not at all, and then the card's step again, from the same weights,
    with every ReLU taking the CPU step's decisions, both to 1e-4 (CSN to
    its ``HELD_LIMITS``); the running statistics to 1e-6 beyond rtol 1e-4
    (in float32, CSN and R(2+1)D to their ``STATS_LIMITS``); for a model in
    ``grad_witness.FLOAT64_HELD`` (SlowFast, R(2+1)D) that step's readings
    are printed, and the step is run again in float64 on both sides on
    ``FLOAT64_FRAMES`` of the batch's frames, every gate at 1e-4."""
    from pmv_tpu_torch.engine.steps import init_state, make_train_step
    from pmv_tpu_torch.tools.grad_witness import (
        FLOAT64_HELD, HELD_LIMITS, RELU_LIMITS, STATS_LIMITS, relu_decisions, stats_distance,
        witness_key)

    lr = cfg.SOLVER.BASE_LR
    name = witness_key(cfg)
    held_limit = HELD_LIMITS.get(name, 1e-4)
    stats_limit = STATS_LIMITS.get(name, 1e-6) if dtype == torch.float32 else 1e-6
    free = dtype == torch.float32 and name in RELU_LIMITS  # ReLUs that jump
    cpu_model, gpu_model = models or _models_card_and_cpu(cfg, dtype)
    before = {k: v.detach().clone() for k, v in cpu_model.state_dict().items()}
    cpu_state, gpu_state = init_state(cfg, cpu_model), init_state(cfg, gpu_model)
    cpu_step = make_train_step(cfg, device="cpu", seed=0)
    gpu_step = make_train_step(cfg, device="cuda", seed=0)
    draws = cpu_step.sample_draws(cpu_model, batch["frames"].shape)
    grad_limit = RELU_LIMITS[name] if free else 1e-4
    # The grad norm of a step whose ReLUs decide on their own is read, not
    # held (RELU_LIMITS); with the CPU's decisions held it is held below.
    norm_limit = None if free else 1e-4

    counts = _launch_counts()
    t0 = time.perf_counter()
    gpu = {k: v.cpu() for k, v in gpu_step(gpu_state, batch, lr, draws).items()}
    gpu_s = time.perf_counter() - t0
    launches = _launches_since(counts)
    t0 = time.perf_counter()
    with relu_decisions() as cpu_decisions:
        cpu = cpu_step(cpu_state, batch, lr, draws)
    cpu_s = time.perf_counter() - t0

    cpu_grads, gpu_grads = _grads(cpu_model), _grads(gpu_model)
    grad_rel = _grad_rel_err(gpu_grads, cpu_grads)
    grad_max = max(float((gpu_grads[k] - v).abs().max()) for k, v in cpu_grads.items())
    worst = sorted((float((gpu_grads[k] - v).norm()), k, float(v.norm()))
                   for k, v in cpu_grads.items())[-3:]
    worst = [{"param": n, "grad_l2_diff": d, "grad_l2": g} for d, n, g in worst]
    params_gpu = {k: v.detach().cpu() for k, v in gpu_model.named_parameters()}
    params_cpu = {k: v.detach() for k, v in cpu_model.named_parameters()}
    param_err = max(float((params_gpu[k] - v).abs().max()) for k, v in params_cpu.items())
    n_params = sum(v.numel() for v in params_cpu.values())
    n_off = sum(int(((params_gpu[k] - v).abs() > 1e-6).sum()) for k, v in params_cpu.items())
    moved = sum(int((v != before[k]).sum()) for k, v in params_cpu.items())
    # BatchNorm running statistics (none in MViT).
    stats_err, stats_abs = _running_stats_err(gpu_model, cpu_model)
    stats_cpu = {k: v for k, v in cpu_model.named_buffers() if "running" in k}
    stats_moved = sum(int((v != before[k]).sum()) for k, v in stats_cpu.items())
    n_stats = sum(v.numel() for v in stats_cpu.values())
    rec = {
        "phase": phase, "model": name, "dtype": str(dtype),
        "frames": list(batch["frames"].shape),
        "launches": launches, "loss": [float(gpu["loss"]), float(cpu["loss"])],
        "grad_norm": [float(gpu["grad_norm"]), float(cpu["grad_norm"])],
        "top1_err": [float(gpu["top1_err"]), float(cpu["top1_err"])],
        "top5_err": [float(gpu["top5_err"]), float(cpu["top5_err"])],
        "grad_rel_err": grad_rel, "grad_limit": grad_limit, "grad_norm_limit": norm_limit,
        "grads_furthest_apart": worst, "param_max_abs_err": param_err,
        "params_off_by_1e-6": n_off, "params": n_params, "params_moved": moved,
        "bn_stats": n_stats, "bn_stats_moved": stats_moved,
        "bn_stats_max_abs_err": stats_abs, "bn_stats_err_over_rtol": stats_err,
        "bn_stats_limit": stats_limit,
        "bn_stats_furthest": stats_distance(_running_stats(gpu_model),
                                            _running_stats(cpu_model))["tensor"],
        "gpu_first_call_s": gpu_s, "cpu_s": cpu_s,
    }
    held = None
    if free:
        # The card's step again from the same weights, deciding each ReLU as
        # the CPU step did.
        held_model = seeded_model(cfg, "cuda", torch.float32)
        held_model.load_state_dict(before, strict=True)
        with relu_decisions(cpu_decisions) as card_decisions:
            held = gpu_step(init_state(cfg, held_model), batch, lr, draws)
        rec["relu_decisions_held"] = {
            "limit": held_limit, "grad_rel_err": _grad_rel_err(_grads(held_model), cpu_grads),
            "grad_norm": float(held["grad_norm"]),
            "relu_elements": sum(int(m.numel()) for m in cpu_decisions.masks),
            "card_decisions_otherwise": card_decisions.taken_otherwise,
        }
    avs = sorted(k for k in cpu if k.endswith("_avs"))  # AVSlowFast's AVS losses
    if avs:
        rec["avs_losses"] = {k: [float(gpu[k]), float(cpu[k])] for k in avs}
        rec["drop_pathway"] = draws["drop_pathway"]
    log(json.dumps(rec))
    if launches != expected:
        raise AssertionError(f"{phase}: one train step launched {launches}, not {expected}")
    torch.testing.assert_close(gpu["loss"], cpu["loss"], atol=0, rtol=1e-4)
    for key in avs:
        torch.testing.assert_close(gpu[key], cpu[key], atol=1e-6, rtol=1e-4)
    if norm_limit is not None:
        torch.testing.assert_close(gpu["grad_norm"], cpu["grad_norm"], atol=0, rtol=norm_limit)
    for key in ("top1_err", "top5_err", "nan"):
        if not torch.equal(gpu[key], cpu[key]):
            raise AssertionError(f"{key}: card {gpu[key]} against CPU {cpu[key]}")
    if grad_rel > grad_limit:
        raise AssertionError(f"gradients differ by {grad_rel} (relative L2), over {grad_limit}")
    if held is not None and name not in FLOAT64_HELD:
        torch.testing.assert_close(held["grad_norm"].cpu(), cpu["grad_norm"], atol=0,
                                   rtol=held_limit)
        if rec["relu_decisions_held"]["grad_rel_err"] > held_limit:
            raise AssertionError(f"with the CPU's ReLU decisions the gradients differ by "
                                 f"{rec['relu_decisions_held']['grad_rel_err']}, over "
                                 f"{held_limit}")
    if cfg.SOLVER.OPTIMIZING_METHOD == "sgd":
        # SGD's first step is linear in the gradient: lr (1 + momentum) g
        # with Nesterov momentum, plus the weight decay, equal on both
        # sides; and one rounding of the weight.
        params_ok = param_err <= (1 + cfg.SOLVER.MOMENTUM) * lr * grad_max * 1.0001 + 1e-6
    else:
        # AdamW's first step moves each weight by about lr * sign(g); a
        # gradient element within float noise of 0 (the K-norm bias, which
        # the loss does not depend on) may take the other sign on the two
        # sides: 2 lr at most, and few such elements.
        params_ok = param_err <= 2.0001 * lr and n_off <= 1e-4 * n_params
    if not params_ok:
        raise AssertionError(
            f"updated parameters differ: max {param_err}, {n_off} off by > 1e-6"
        )
    if moved < 0.5 * n_params:
        raise AssertionError(f"only {moved} of {n_params} weights moved")
    if stats_err > stats_limit or stats_moved < 0.5 * n_stats:
        raise AssertionError(f"running statistics: {stats_err} over rtol 1e-4 (limit "
                             f"{stats_limit}), {stats_moved} of {n_stats} moved")
    if free and name in FLOAT64_HELD:
        # FLOAT64_FRAMES evenly strided frames (8 of SlowFast's 32 and of
        # R(2+1)D's 16): the same step and gates at a fraction of the CPU's
        # float64 time, which keeps the script's wall time under 600 s.
        fewer = dict(batch, frames=_fewer_frames(batch["frames"], FLOAT64_FRAMES))
        _train_step_card_vs_cpu(phase.replace("_f32_", f"_f64_t{FLOAT64_FRAMES}_"), cfg, fewer,
                                expected, dtype=torch.float64)


def phase_train_step_vs_cpu(cfg, per_forward, phase="train_step_f32_b2_card_vs_cpu", clips=2):
    """One full-width float32 train step at batch ``clips``, card against
    CPU, from the same weights and the same draws."""
    rng = np.random.default_rng(2)
    size = cfg.DATA.TRAIN_CROP_SIZE
    batch = {
        "frames": rng.integers(0, 256, (clips, cfg.DATA.NUM_FRAMES, size, size, 3), np.uint8),
        "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, clips),
    }
    _train_step_card_vs_cpu(phase, cfg, batch, step_launches(per_forward))


def phase_portrait_steps(cfg, per_forward, prefix=""):
    """The pm eval step, then the pm train step, at full width in float32
    on one portrait and one landscape row of the PMV rect crop, card against
    CPU. Eval runs each row once, in its orientation; so does MViT's train
    step, but a model with BatchNorm trains on the whole batch in both
    orientations (``steps.select_by_orientation``)."""
    from pmv_tpu_torch.engine.steps import make_eval_step

    cfg = cfg.clone()
    cfg.DATA.TRAIN_CROP_SIZE_RECT = list(PMV_RECT)
    cfg.DATA.TRAIN_CROP_SIZE_RECT_SWITCH_AUTO = True  # no rel-pos tables in UniFormer, X3D
    rng = np.random.default_rng(4)
    batch = {
        "frames": rng.integers(0, 256, (2, cfg.DATA.NUM_FRAMES, *PMV_RECT, 3), np.uint8),
        "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, 2),
        "pm": np.array([True, False]),
    }
    models = _models_card_and_cpu(cfg)
    cpu_eval, gpu_eval = (make_eval_step(cfg, m, device=m_dev)
                          for m, m_dev in zip(models, ("cpu", "cuda")))
    counts = _launch_counts()
    gpu_pm = gpu_eval(batch["frames"], batch["pm"]).cpu()
    launches = _launches_since(counts)
    gpu_plain = gpu_eval(batch["frames"]).cpu()
    cpu_pm = cpu_eval(batch["frames"], batch["pm"])
    err = float((gpu_pm - cpu_pm).abs().max())
    row_err = float((gpu_pm[1] - gpu_plain[1]).abs().max())
    log(json.dumps({
        "phase": f"{prefix}pm_eval_step_f32_b2_card_vs_cpu", "model": cfg.MODEL.MODEL_NAME,
        "launches": launches,
        "max_abs_err_vs_cpu": err, "landscape_row_vs_plain_step": row_err,
        "portrait_row_vs_plain_step": float((gpu_pm[0] - gpu_plain[0]).abs().max()),
    }))
    if launches != eval_launches(2 * per_forward):
        raise AssertionError(f"the pm eval step launched {launches}, not 2 x {per_forward} K1")
    if not torch.isfinite(gpu_pm).all():
        raise AssertionError("non-finite class scores on the card")
    torch.testing.assert_close(gpu_pm, cpu_pm, atol=1e-4, rtol=0)
    torch.testing.assert_close(gpu_pm[1], gpu_plain[1], atol=1e-5, rtol=0)
    # Two forwards either way: one per orientation group (one row each), or
    # with BatchNorm the whole batch in each orientation.
    _train_step_card_vs_cpu(f"{prefix}pm_train_step_f32_b2_card_vs_cpu", cfg, batch,
                            step_launches(2 * per_forward), models=models)


def phase_precise_bn(cfg, per_forward, prefix="", dtype=torch.float32, cpu_float32=None):
    """Precise BN over 2 batches of 2 clips at the train crop, activations in
    ``dtype``, card against CPU from the same weights (a loader of 3
    batches, of which BN.NUM_BATCHES_PRECISE 2 are read): the running
    statistics under phase 3b's BatchNorm gate, every tensor of them moved,
    ``num_batches_tracked`` and the weights left as they were,
    ``per_forward`` K1 launches a batch. For a model in
    ``grad_witness.FLOAT64_HELD`` (SlowFast) the float32 statistics are
    printed and the gate holds the float64 ones, beside which the CPU's
    float32 statistics (``cpu_float32``) are read against its float64 ones;
    both runs then take ``FLOAT64_FRAMES`` of the clips' frames (the CPU's
    float64 time)."""
    from pmv_tpu_torch.engine.precise_bn import calculate_and_update_precise_bn
    from pmv_tpu_torch.engine.steps import init_state
    from pmv_tpu_torch.tools.grad_witness import FLOAT64_HELD

    cfg = cfg.clone()
    cfg.BN.NUM_BATCHES_PRECISE = 2
    rng = np.random.default_rng(6)
    size = cfg.DATA.TRAIN_CROP_SIZE
    frames = FLOAT64_FRAMES if cfg.MODEL.MODEL_NAME in FLOAT64_HELD else cfg.DATA.NUM_FRAMES
    loader = [{"frames": rng.integers(0, 256, (2, frames, size, size, 3), np.uint8)}
              for _ in range(3)]
    cpu_model, gpu_model = _models_card_and_cpu(cfg, dtype)
    before = {k: v.detach().clone() for k, v in cpu_model.state_dict().items()}
    counts = _launch_counts()
    t0 = time.perf_counter()
    calculate_and_update_precise_bn(loader, init_state(cfg, gpu_model), cfg, "cuda")
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = _launches_since(counts)
    calculate_and_update_precise_bn(loader, init_state(cfg, cpu_model), cfg, "cpu")
    stats_err, stats_abs = _running_stats_err(gpu_model, cpu_model)
    after = cpu_model.state_dict()
    moved = sum(int((after[k] != v).any()) for k, v in before.items() if "running" in k)
    n_stats = sum("running" in k for k in before)
    kept = all(torch.equal(after[k], v) for k, v in before.items() if "running" not in k)
    gpu_kept = all(torch.equal(gpu_model.state_dict()[k].cpu(), v)
                   for k, v in before.items() if "running" not in k)
    gated = dtype == torch.float64 or cfg.MODEL.MODEL_NAME not in FLOAT64_HELD
    rec = {
        "phase": f"{prefix}precise_bn_{'f64' if dtype == torch.float64 else 'f32'}_card_vs_cpu",
        "model": cfg.MODEL.MODEL_NAME, "gated": gated, "frames": frames,
        "batches": cfg.BN.NUM_BATCHES_PRECISE, "launches": launches, "bn_stats_tensors": n_stats,
        "bn_stats_tensors_moved": moved, "bn_stats_max_abs_err": stats_abs,
        "bn_stats_err_over_rtol": stats_err, "gpu_s": gpu_s,
    }
    if cpu_float32 is not None:
        over, diff = _stats_err(cpu_float32, _running_stats(cpu_model))
        rec["cpu_f32_vs_f64"] = {"bn_stats_max_abs_err": diff, "bn_stats_err_over_rtol": over}
    log(json.dumps(rec))
    if launches != eval_launches(2 * per_forward):
        raise AssertionError(f"precise BN launched {launches}, not 2 x {per_forward} K1")
    if gated and stats_err > 1e-6 or moved != n_stats or not (kept and gpu_kept):
        raise AssertionError(f"precise BN: {stats_err} over rtol 1e-4, {moved} of {n_stats} "
                             "statistics moved, or a weight or count moved")
    if not gated:
        phase_precise_bn(cfg, per_forward, prefix, torch.float64, _running_stats(cpu_model))


def phase_serve(card, cfg, per_forward, prefix=""):
    """A main path: the multi-view test loop over synthetic clips of 4
    videos (TEST.NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS each) at batch 8,
    bfloat16."""
    from pmv_tpu_torch.engine.steps import make_eval_step
    from pmv_tpu_torch.engine.test import perform_test
    from pmv_tpu_torch.utils.meters import TestMeter

    num_videos, batch = 4, 8
    num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    model = seeded_model(cfg, "cuda")  # bfloat16 activations
    eval_step = make_eval_step(cfg, model, device="cuda")

    rng = np.random.default_rng(0)
    n = num_videos * num_clips
    size = cfg.DATA.TEST_CROP_SIZE
    clips = rng.integers(0, 256, (n, cfg.DATA.NUM_FRAMES, size, size, 3), np.uint8)
    labels = rng.integers(0, cfg.MODEL.NUM_CLASSES, num_videos)
    loader = [
        {"frames": clips[i:i + batch], "index": np.arange(i, min(i + batch, n)),
         "labels": labels[np.arange(i, min(i + batch, n)) // num_clips]}
        for i in range(0, n, batch)
    ]
    if cfg.MODEL.ARCH == "avslowfast":  # each clip with its log-mel
        audio = av_logmels(cfg, rng, n)
        for i, b in zip(range(0, n, batch), loader):
            b["audio"] = audio[i:i + batch]
    warm = {"audio": loader[0]["audio"]} if "audio" in loader[0] else {}
    eval_step(loader[0]["frames"], **warm)  # warm-up: cuDNN and cuBLAS plans
    torch.cuda.synchronize()

    outputs = []

    def serving_step(frames, **audio):
        preds = eval_step(frames, **audio)
        outputs.append(preds)
        return preds

    meter = TestMeter(num_videos, num_clips, cfg.MODEL.NUM_CLASSES, len(loader))
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    meter, stats = perform_test(loader, serving_step, meter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    preds = torch.cat(outputs).float().cpu()
    if preds.shape != (n, cfg.MODEL.NUM_CLASSES) or not torch.isfinite(preds).all():
        raise AssertionError(f"bad class scores: shape {tuple(preds.shape)}")
    np.testing.assert_array_equal(meter.clip_count, [num_clips] * num_videos)
    if cfg.MODEL.MODEL_NAME in ("MViT", "X3D", "SlowFast", "PTVCSN", "PTVR2plus1D",
                                "AVSlowFast"):
        # softmax'd; UniFormer's are logits
        torch.testing.assert_close(preds.sum(dim=1), torch.ones(n), atol=1e-3, rtol=0)
        np.testing.assert_allclose(meter.video_preds.sum(axis=1), num_clips, atol=1e-2)
    if launches != eval_launches(per_forward * len(loader)):
        raise AssertionError(f"serving launched {launches} kernels, not {per_forward} per batch")
    log(json.dumps({
        "phase": f"{prefix}serve_bf16_b8", "model": cfg.MODEL.MODEL_NAME, "card": card,
        "views": num_clips, "videos": num_videos,
        "clips": n, "batches": len(loader), "wall_s": wall,
        "clips_per_s": n / wall, "ms_per_batch": wall / len(loader) * 1e3,
        "max_memory_allocated_bytes": peak, "launches": launches,
        "stats": stats,
    }))
    return launches


def _profiled(steps):
    """The device's busy share over ``steps`` (callables, each a train step
    that ends on the host's side), and the share of that busy time in which
    K1 and the wgrad kernel ran (``tools/profile_eval.py``'s kinds)."""
    from pmv_tpu_torch.tools.profile_eval import kind_of, union_us

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for step in steps:
            step()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    intervals = {}
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            intervals.setdefault(kind_of(evt.name), []).append(
                (evt.time_range.start, evt.time_range.end))
    busy_us = union_us([iv for ivs in intervals.values() for iv in ivs])
    if busy_us == 0:
        raise AssertionError("the profiler saw no CUDA kernel")
    return {
        "steps": len(steps), "window_ms_per_step": window_us / len(steps) / 1e3,
        "busy_ms_per_step": busy_us / len(steps) / 1e3, "busy_share": busy_us / window_us,
        "k1_share_of_busy": union_us(intervals.get("depthwise3x3x3 (K1)", [])) / busy_us,
        "wgrad_share_of_busy": union_us(intervals.get("depthwise wgrad", [])) / busy_us,
    }


def phase_train(card, cfg, per_forward, prefix="", timed=2, profile=False, model=None):
    """A main path: train_epoch over ``timed`` synthetic batches of 8 clips
    (with boxes for a detection config) after one warm-up batch, from
    ``model`` (on the card, in the config's dtype) or the seeded init; with
    ``profile``, 2 more steps under the profiler after it (``_profiled``)."""
    from pmv_tpu_torch.engine.steps import init_state, make_train_step
    from pmv_tpu_torch.engine.train import train_epoch
    from pmv_tpu_torch.utils.meters import TrainMeter

    cfg = cfg.clone()
    batch = 8
    cfg.LOG_PERIOD = timed
    cfg.SOLVER.MAX_EPOCH = 1
    if model is None:
        model = seeded_model(cfg, "cuda")  # bfloat16 activations
    state = init_state(cfg, model)
    step = make_train_step(cfg, device="cuda", seed=0)
    metrics = []

    def recording_step(state, batch, lr):
        m = step(state, batch, lr)
        metrics.append(m)
        return m

    rng = np.random.default_rng(3)
    size = cfg.DATA.TRAIN_CROP_SIZE
    loader = [
        {"frames": rng.integers(0, 256, (batch, cfg.DATA.NUM_FRAMES, size, size, 3), np.uint8),
         "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, batch)}
        for _ in range(1 + max(timed, 2 if profile else 0))
    ]
    if cfg.DETECTION.ENABLE:  # 16 box slots a clip, 3 valid, multi-hot labels
        from pmv_tpu_torch.tools.grad_witness import detection_boxes

        for b in loader:
            b.update(detection_boxes(batch, size, cfg.MODEL.NUM_CLASSES, rng))
    if cfg.MODEL.ARCH == "avslowfast":  # the audio, and the misaligned audio
        for b in loader:              # that train_epoch rolls into easy negatives
            b["audio"], b["audio_mis"] = av_logmels(cfg, rng, batch), av_logmels(cfg, rng, batch)
    t0 = time.perf_counter()
    train_epoch(loader[:1], recording_step, state, TrainMeter(1, cfg), 0, cfg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    train_epoch(loader[1:1 + timed], recording_step, state, TrainMeter(timed, cfg), 0, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    profiled = None
    if profile:
        profiled = _profiled([functools.partial(step, state, b, cfg.SOLVER.BASE_LR)
                              for b in loader[1:3]])

    losses = [float(m["loss"]) for m in metrics]
    grad_norms = [float(m["grad_norm"]) for m in metrics]
    if not np.all(np.isfinite(losses + grad_norms)):
        raise AssertionError(f"non-finite losses {losses} or grad norms {grad_norms}")
    if launches != {k: n * timed for k, n in step_launches(per_forward).items()}:
        raise AssertionError(f"{timed} train steps launched {launches}, not "
                             f"{step_launches(per_forward)} per step")
    log(json.dumps({
        "phase": f"{prefix}train_bf16_b8", "model": cfg.MODEL.MODEL_NAME, "card": card,
        "steps": timed, "batch": batch,
        "wall_s": wall, "ms_per_step": wall / timed * 1e3,
        "clips_per_s": timed * batch / wall, "warmup_step_s": warm_s,
        "max_memory_allocated_bytes": peak, "launches": launches,
        "losses": losses, "grad_norms": grad_norms, "steps_taken": state.step,
        "profile": profiled,
    }))
    return launches


def _run_net_opts(recipe):
    """Per model: the PMV rect recipe's opts (exps/PMV/run_MViT_PMV.sh run 3,
    the rect_256_192 runs of exps/PMV/run_Uniformer_PMV.sh and
    exps/PMV/run_X3D_PMV.sh) and the test protocol: for MViT a test crop
    equal to the train rect (its rel-pos tables are sized by the crop) and 2
    views; for UniFormer the recipe's 4 views x 1 crop at 224^2, without
    pretrained weights and TensorBoard; for X3D, and for SlowFast with X3D's
    rect options, 2 of the recipe's 10 views at its 256^2 test crop (1
    spatial crop, as for the others); for CSN and R(2+1)D their yamls'
    224^2 train and 256^2 test crops, 2 views (AVSlowFast's on ``Synthetic_av``,
    ``register_synthetic_av``); for MaskFeat's fine-tuning (FT yaml)
    its own 224^2 crops, a 1-view test and CLEAR_NAME_PATTERN
    ["backbone."]; for Slow R50's fine-tuning from a contrastive checkpoint
    the same, the epoch reset."""
    rect = f"[{PMV_RECT[0]},{PMV_RECT[1]}]"
    common = [
        "DATA.TRAIN_JITTER_ASPECT_RELATIVE", "[]",
        "DATA.TRAIN_JITTER_SCALES_RELATIVE", "[]",
        "DATA.TRAIN_JITTER_SCALES_AUTO_ADJUST", "True",
        "DATA.TRAIN_CROP_SIZE_RECT", rect,
    ]
    if recipe == "mvit":
        return common + ["DATA.TEST_CROP_SIZE_RECT", rect, "TEST.NUM_ENSEMBLE_VIEWS", "2"]
    if recipe in ("x3d", "slowfast"):
        return common + ["TEST.NUM_ENSEMBLE_VIEWS", "2"]
    if recipe in ("csn", "r2plus1d"):  # the yamls' own crops; a 2-view test
        return ["TEST.NUM_ENSEMBLE_VIEWS", "2"]
    if recipe == "avslowfast":  # its yaml's crops, a 2-view test, clips with audio
        return ["TEST.NUM_ENSEMBLE_VIEWS", "2", "TRAIN.DATASET", "synthetic_av",
                "TEST.DATASET", "synthetic_av"]
    if recipe == "maskfeat_ft":  # the FT yaml's own crops; a 1-view test
        return ["TEST.NUM_TEMPORAL_CLIPS", "[]", "TEST.NUM_ENSEMBLE_VIEWS", "1",
                "TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN", "['backbone.']"]
    if recipe == "slow_ft":  # from a contrastive checkpoint: its backbone, epoch 0
        return ["TEST.NUM_ENSEMBLE_VIEWS", "1",
                "TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN", "['backbone.']",
                "TRAIN.CHECKPOINT_EPOCH_RESET", "True"]
    return common + [
        "UNIFORMER.PRETRAIN_NAME", "",
        "TENSORBOARD.ENABLE", "False",
        "DATA.TEST_CROP_SIZE", "224",
        "TEST.NUM_ENSEMBLE_VIEWS", "4",
    ]


RUN_NET = {  # recipe -> (config file, K1 launches per forward, clips a train step)
    "mvit": (MVIT_CFG, MVIT_K1, 16),
    "uniformer": (UNIFORMER_CFG, UNIFORMER_K1, 16),
    "x3d": (X3D_CFG, X3D_K1, 8),  # no repeated augmentation in X3D's recipe
    "slowfast": (SLOWFAST_CFG, SLOWFAST_K1, 8),
    "maskfeat_ft": (MASKFEAT_FT_CFG, MASKFEAT_FT_K1, 8),  # 4 videos x AUG.NUM_SAMPLE 2
    "slow_ft": (SLOW_CFG, SLOW_K1, 8),
    "csn": (CSN_CFG, CSN_K1, 8),
    "r2plus1d": (R2PLUS1D_CFG, R2PLUS1D_K1, 8),
    "avslowfast": (AVSLOWFAST_CFG, AVSLOWFAST_K1, 8),
}


def run_net_argv(recipe, out_dir, max_epoch):
    """run_net's arguments: ``recipe``'s config with its PMV rect opts on the
    Synthetic dataset (or the one its opts name), batch 8, bfloat16 (the
    config's MIXED_PRECISION)."""
    return [
        "--cfg", RUN_NET[recipe][0], "--opts",
        "TRAIN.DATASET", "synthetic",
        "TEST.DATASET", "synthetic",
        *_run_net_opts(recipe),
        "SOLVER.BASE_LR", "1e-4",
        "MODEL.NUM_CLASSES", "400",
        "TRAIN.BATCH_SIZE", "8",
        "TEST.BATCH_SIZE", "8",
        "TEST.NUM_SPATIAL_CROPS", "1",
        "NUM_GPUS", "1",  # one process on the one card (the yamls say 8)
        "SOLVER.MAX_EPOCH", str(max_epoch),
        "OUTPUT_DIR", out_dir,
    ]


def run_net_cfg(argv):
    """The cfg that run_net builds from ``argv``."""
    from pmv_tpu_torch.config.defaults import assert_and_infer_cfg
    from pmv_tpu_torch.config.parser import load_config, parse_args

    args = parse_args(argv)
    return assert_and_infer_cfg(load_config(args, args.cfg_files[0]))


def run_net_train_batch(cfg):
    """Clips in one train step of ``cfg``: TRAIN.BATCH_SIZE videos, each
    AUG.NUM_SAMPLE clips (``multiple_samples_collate``)."""
    return cfg.TRAIN.BATCH_SIZE * (cfg.AUG.NUM_SAMPLE if cfg.AUG.ENABLE else 1)


def _compare_restored(state, ckpt, start):
    """Every weight and every optimizer tensor of ``state`` against the
    checkpoint's; raises on the first that differs."""
    if start != ckpt["epoch"] + 1:
        raise AssertionError(f"resumed at epoch {start}, not {ckpt['epoch'] + 1}")
    n = n_bn = 0
    for name, value in state.model.state_dict().items():
        if not torch.equal(value.cpu(), ckpt["model_state"][name]):
            raise AssertionError(f"restored weight {name} differs from the checkpoint's")
        n += 1
        n_bn += "running" in name or "num_batches_tracked" in name
    opt = state.optimizer.state_dict()
    if opt["param_groups"] != ckpt["optimizer_state"]["param_groups"]:
        raise AssertionError("restored optimizer groups (count, lr) differ")
    for i, entries in ckpt["optimizer_state"]["state"].items():
        for key, value in entries.items():
            if not torch.equal(opt["state"][i][key].cpu(), value):
                raise AssertionError(f"restored optimizer state {i}.{key} differs")
            n += 1
    return {"start_epoch": start, "tensors_equal": n, "bn_buffers_equal": n_bn,
            "step": state.step}


def check_restore(cfg):
    """Build the model and the optimizer as ``train()`` does and restore the
    last checkpoint through ``load_train_checkpoint``, as it does; every
    tensor must equal the file's."""
    from pmv_tpu_torch.engine.steps import init_state
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.utils import checkpoint as cu

    state = init_state(cfg, build_model(cfg, device="cuda", seed=cfg.RNG_SEED))
    last = cu.get_last_checkpoint(cfg.OUTPUT_DIR, cfg.TASK)
    start = cu.load_train_checkpoint(cfg, state)
    ckpt = torch.load(last, map_location="cpu", weights_only=True)
    return {"checkpoint": last, **_compare_restored(state, ckpt, start)}


def _last_match(lines, pattern):
    """The last match of ``pattern`` in ``lines``; raises if none."""
    found = [m for m in map(re.compile(pattern).search, lines) if m]
    if not found:
        raise AssertionError(f"run_net logged no line like {pattern!r}")
    return found[-1]


def _run_net_call(recipe, out_dir, max_epoch, extra=()):
    """One ``run_net`` call (a main path: launch counts zeroed just before it
    and read just after), measured from its own log: the epoch's seconds
    (its EpochTimer line), the eval's, the checkpoint's write, and the
    test's (the sum of its test_iter times); with BN.USE_PRECISE_STATS, its
    precise-BN line. ``extra`` opts go after the recipe's."""
    from pmv_tpu_torch.data.loader import construct_loader
    from pmv_tpu_torch.tools import run_net

    argv = run_net_argv(recipe, out_dir, max_epoch) + list(extra)
    cfg = run_net_cfg(argv)
    _, per_forward, train_batch = RUN_NET[recipe]
    if run_net_train_batch(cfg) != train_batch:
        raise AssertionError("phase 2 holds the kernels at a train batch of "
                             f"{train_batch}, run_net takes {run_net_train_batch(cfg)}")
    steps, evals, tests = (construct_loader(cfg, split) for split in ("train", "val", "test"))
    precise = min(cfg.BN.NUM_BATCHES_PRECISE, len(steps)) if cfg.BN.USE_PRECISE_STATS else 0
    log_path = os.path.join(out_dir, "stdout.log")
    skip = 0
    if os.path.exists(log_path):
        with open(log_path) as f:
            skip = len(f.read().splitlines())

    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    run_net.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    with open(log_path) as f:
        lines = f.read().splitlines()[skip:]
    stats = [json.loads(line.split("json_stats: ", 1)[1])
             for line in lines if "json_stats: " in line]
    final = stats[-1]
    if final.get("split") != "test_final":
        raise AssertionError(f"run_net ended without test_final stats: {final}")
    train_stats = [s for s in stats if s.get("_type") == "train_epoch"][-1]
    if not np.isfinite(train_stats["loss"]):
        raise AssertionError(f"non-finite train loss {train_stats}")
    expected = {
        "depthwise3x3x3": 2 * per_forward * len(steps)
        + per_forward * (len(evals) + len(tests) + precise),
        "depthwise3x3x3_wgrad": per_forward * len(steps),
    }
    if launches != expected:
        raise AssertionError(f"run_net launched {launches}, not {expected}")
    if precise and int(_last_match(lines, r"Updated precise BN stats over (\d+) batches")[1]) \
            != precise:
        raise AssertionError(f"run_net's precise BN did not run over {precise} batches")
    epoch = max_epoch - 1
    epoch_s = float(_last_match(lines, rf"Epoch {epoch} takes ([\d.]+)s")[1])
    eval_s = float(_last_match(lines, rf"Eval of epoch {epoch} takes ([\d.]+)s")[1])
    saved = _last_match(lines, r"Saved checkpoint to (\S+) in ([\d.]+)s")
    test_s = sum(s["time_diff"] for s in stats if s.get("split") == "test_iter")
    train_clips = len(steps) * train_batch
    return {
        "phase": f"run_net_epoch_{max_epoch}", "recipe": recipe, "wall_s": wall,
        "epoch_s": epoch_s, "train_clips": train_clips, "train_steps": len(steps),
        # Over the whole epoch: its first step and the loader's start included.
        "train_clips_per_s": train_clips / epoch_s, "precise_bn_batches": precise,
        "eval_s": eval_s, "eval_clips_per_s": len(evals.dataset) / eval_s,
        "test_s": test_s, "test_clips_per_s": len(tests.dataset) / test_s,
        "checkpoint": saved[1], "checkpoint_s": float(saved[2]),
        "checkpoint_bytes": os.path.getsize(saved[1]),
        "optimizer_steps": torch.load(saved[1], map_location="cpu", weights_only=True)[
            "optimizer_state"]["param_groups"][0]["count"],
        "max_memory_allocated_bytes": peak, "launches": launches,
        "train_epoch_stats": train_stats, "final_stats": final, "log": lines,
    }


def phase_run_net(card, recipe, out_dir, resume=True):
    """``run_net`` in this process at full width with the PMV rect crop, for
    one epoch; with ``resume``, the restore of its checkpoint, every tensor
    compared, then ``run_net`` again with SOLVER.MAX_EPOCH 2, which must
    resume from that checkpoint. Returns the launches of each call."""
    from contextlib import redirect_stdout

    # The runs log to OUTPUT_DIR/stdout.log; keep them off ours. The sink
    # stays open: the port's logger keeps it as its stream after the block.
    with redirect_stdout(open(os.devnull, "w")):
        first = _run_net_call(recipe, out_dir, 1)
        if resume:
            restored = check_restore(run_net_cfg(run_net_argv(recipe, out_dir, 2)))
            second = _run_net_call(recipe, out_dir, 2)
    if not resume:
        first.pop("log")
        log(json.dumps({**first, "card": card}))
        return [first["launches"]]
    if restored["start_epoch"] != 1 or restored["checkpoint"] != first["checkpoint"]:
        raise AssertionError(f"the restore did not start after epoch 1: {restored}")
    resumed = f"Load from last checkpoint, {first['checkpoint']}."
    if not (any(resumed in line for line in second["log"])
            and any("Start epoch: 2" in line for line in second["log"])):
        raise AssertionError("the second call did not resume from the first's checkpoint")
    if second["optimizer_steps"] != first["optimizer_steps"] + second["train_steps"]:
        raise AssertionError(
            f"the optimizer took {second['optimizer_steps']} steps in all, not "
            f"{first['optimizer_steps']} + {second['train_steps']}"
        )
    for rec in (first, second):
        rec.pop("log")
        log(json.dumps({**rec, "card": card}))
    log(json.dumps({"phase": "run_net_restore", "recipe": recipe, **restored}))
    return [first["launches"], second["launches"]]


# AVSlowFast 8x8 R50 (configs/Kinetics/AVSLOWFAST_8x8_R50.yaml), phases
# 3v-6v.


def avslowfast_cfg(*opts):
    """AVSlowFast 8x8 R50 with its yaml's recipe (cross-entropy plus the AVS
    losses, DropPathway, head dropout 0.5, SGD with momentum) at the PMV X3D
    recipe's LR (``X3D_LR``), and a test of 3 crops of 256^2 with the views
    cut from 10 to 2; ``opts`` after them."""
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(AVSLOWFAST_CFG)
    cfg.SOLVER.BASE_LR = X3D_LR
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    cfg.merge_from_list(list(opts))
    return cfg


def av_logmels(cfg, rng, n):
    """``n`` log-mel clips [n, AUDIO_FRAME_NUM, AUDIO_MEL_NUM] of the
    loader's pipeline (``data/audio.gen_logmel``), each of a window of
    noise and a tone from ``rng`` as long as the clip."""
    from pmv_tpu_torch.data.kinetics_av import logmel

    sr = cfg.DATA.AUDIO_SAMPLE_RATE
    t = np.arange(int(cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE / 30.0 * sr)) / sr
    return np.stack([logmel(cfg, (np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
                                  + rng.normal(size=t.shape)).astype(np.float32))
                     for _ in range(n)])


def register_synthetic_av():
    """Register DATASET "Synthetic_av" (once): ``Synthetic``'s clips, each
    with "audio" and "audio_mis" cut from a waveform of its video as
    ``Kinetics_av`` cuts them (``data/kinetics_av.audio_windows``): 10 s of
    noise and a tone at DATA.AUDIO_SAMPLE_RATE drawn from the video's index,
    a 30 fps video, the clip's time a fraction drawn from the sample's
    index in training and the view's place in testing. The card's machine
    has no FFmpeg, so no AVI is decoded there."""
    from pmv_tpu_torch.data.build import DATASET_REGISTRY
    from pmv_tpu_torch.data.kinetics_av import audio_windows, logmel
    from pmv_tpu_torch.data.synthetic import Synthetic

    if "Synthetic_av" in DATASET_REGISTRY:
        return

    class SyntheticAV(Synthetic):
        SECONDS = 10.0

        def __getitem__(self, index):
            sample = super().__getitem__(index)
            cfg = self.cfg
            video, view = divmod(sample["index"], self._num_clips)
            rng = np.random.default_rng((video, 2))
            sr = cfg.DATA.AUDIO_SAMPLE_RATE
            t = np.arange(int(self.SECONDS * sr)) / sr
            wav = (np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
                   + rng.normal(size=t.shape)).astype(np.float32)
            frac = (view / max(self._num_clips - 1, 1) if self.mode == "test"
                    else float(np.random.default_rng((sample["index"], 3)).uniform()))
            start, mis, window = audio_windows(cfg, frac, 30.0, self.SECONDS)

            def cut(s):
                return wav[int(s * sr):int((s + window) * sr)]

            sample["time"] = frac
            sample["audio"] = logmel(cfg, cut(start))
            if mis is not None:
                sample["audio_mis"] = logmel(cfg, cut(mis))
            return sample

    DATASET_REGISTRY.register(SyntheticAV, name="Synthetic_av")


def phase_avslowfast_card_vs_cpu():
    """3v: full-width AVSlowFast at batch 1 on ``AVSLOWFAST_CPU_FRAMES`` of
    its 32 frames (2 slow) of 224^2 and a full log-mel, float32, card against
    CPU: the eval step; then a train step with the misaligned audio at
    DROPPATHWAY_RATE 0 and at 1 (the decision forced on both sides), each
    AVS loss, the loss, the gradients (to ``grad_witness.RELU_LIMITS``; the
    grad norm read), the update and the BatchNorm statistics, then the same
    step in float64 on both sides under every 1e-4 gate
    (``grad_witness.FLOAT64_HELD``). 0 K1 launches each."""
    rng = np.random.default_rng(11)
    cfg = avslowfast_cfg()
    size = cfg.DATA.TRAIN_CROP_SIZE
    frames = rng.integers(0, 256, (1, AVSLOWFAST_CPU_FRAMES, size, size, 3), np.uint8)
    audio = av_logmels(cfg, rng, 1)
    phase_full_model(cfg, frames, AVSLOWFAST_K1, "avslowfast_full_model_f32_b1", audio=audio)
    n_params = sum(p.numel() for p in seeded_model(cfg, "meta", torch.float32).parameters())
    if n_params != AVSLOWFAST_PARAMS:
        raise AssertionError(f"AVSlowFast has {n_params} parameters, not {AVSLOWFAST_PARAMS}")
    batch = {"frames": frames, "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, 1),
             "audio": audio, "audio_mis": av_logmels(cfg, rng, 1)}
    for rate in ("0.0", "1.0"):
        cfg = avslowfast_cfg("SLOWFAST.DROPPATHWAY_RATE", rate)
        _train_step_card_vs_cpu(f"avslowfast_rate{rate[0]}_train_step_f32_b1_card_vs_cpu", cfg,
                                batch, step_launches(AVSLOWFAST_K1))


# CSN, R(2+1)D, the image MViTv2-S and Charades (phases 3n, 3r, 3i, 4n-6n,
# 6r, 6h).


def phase_csn_card_vs_cpu():
    """3n, 3r, 3i: float32 eval and train steps, card against CPU, from one
    seeded init. ir-CSN-101 at batch 1 on ``CSN_CPU_FRAMES`` of its 32
    frames (the CPU reference's time; phase 2 holds the kernels at the full
    32 x 224^2): 30 K1 a forward, 60 K1 and 30 wgrad a train step, its
    gradients held to ``RELU_LIMITS["CSN"]`` free and to
    ``HELD_LIMITS["CSN"]`` with the CPU's ReLU decisions held. R(2+1)D-50 at
    batch 1 on its 16 frames, 0 K1, then in float64 on 8 frames
    (``FLOAT64_HELD``). The image MViTv2-S at batch 2 under MViT's 1e-4
    gates, 0 K1 (its pools are 1x3x3)."""
    rng = np.random.default_rng(1)
    for name, path, k1 in (("csn", CSN_CFG, CSN_K1), ("r2plus1d", R2PLUS1D_CFG, R2PLUS1D_K1)):
        cfg = csn_cfg(path)
        cfg.DATA.NUM_FRAMES = min(cfg.DATA.NUM_FRAMES, CSN_CPU_FRAMES)
        frames = rng.integers(0, 256, (1, cfg.DATA.NUM_FRAMES, 224, 224, 3), np.uint8)
        phase_full_model(cfg, frames, k1, f"{name}_full_model_f32_b1")
        phase_train_step_vs_cpu(cfg, k1, f"{name}_train_step_f32_b1_card_vs_cpu", clips=1)
    cfg = imagenet_mvit_cfg()
    phase_full_model(cfg, rng.integers(0, 256, (2, 1, 224, 224, 3), np.uint8),
                     IMAGENET_MVIT_K1, "imagenet_mvit_full_model_f32_b2")
    phase_train_step_vs_cpu(cfg, IMAGENET_MVIT_K1, "imagenet_mvit_train_step_f32_b2_card_vs_cpu")


CHARADES_VIDEOS = 16
CHARADES_FRAMES = 140  # a clip spans (64 - 1) x 2 + 1 = 127
CHARADES_SIZE = (340, 256)  # W x H of the frames


def write_charades(root, seed=0):
    """A Charades frame dump from ``seed``: ``CHARADES_VIDEOS`` videos of
    ``CHARADES_FRAMES`` JPEG frames (a smooth random picture a video,
    shifted and brightened frame by frame), train.csv with a random set of
    1-3 of the 157 classes a frame, val.csv with one set a video (the
    multi-view test holds a video's labels equal across its views)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    header = "original_vido_id video_id frame_id path labels"
    train, val = [header], [header]

    def labels():
        return ",".join(map(str, sorted(rng.choice(157, rng.integers(1, 4), replace=False))))

    for v in range(CHARADES_VIDEOS):
        name = f"video{v:03d}"
        os.makedirs(os.path.join(root, "frames", name), exist_ok=True)
        base = Image.fromarray(rng.integers(0, 256, (9, 12, 3), np.uint8)).resize(
            (CHARADES_SIZE[0] + CHARADES_FRAMES, CHARADES_SIZE[1]), Image.BILINEAR)
        video = labels()
        for j in range(CHARADES_FRAMES):
            frame = base.crop((j, 0, j + CHARADES_SIZE[0], CHARADES_SIZE[1]))
            frame.point(lambda p, j=j: min(255, p + j % 32)).save(
                os.path.join(root, "frames", name, f"{j:05d}.jpg"), quality=90)
            path = f"{name}/{j:05d}.jpg"
            train.append(f'{name} {v} {j} {path} "{labels()}"')
            val.append(f'{name} {v} {j} {path} "{video}"')
    for split, rows in (("train", train), ("val", val)):
        with open(os.path.join(root, f"{split}.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")


def phase_charades(card, root):
    """6h, a main path: ``run_net`` on configs/Charades/SLOWFAST_16x8_R50.yaml
    at full width (64 frames, 157 classes, bce_logit, sigmoid, a test of 3
    crops ensembled by max) over a frame dump from a seed
    (``write_charades``), overriding only the data paths, NUM_GPUS 1, batch
    8, TRAIN.CHECKPOINT_FILE_PATH "" (its caffe2 checkpoint is not in the
    repository), one epoch, and the test's views, cut from the yaml's 10 to
    2 as in every other phase's test (the host decodes each view's 64
    JPEGs): the train loss finite, the eval epoch's mAP and the test's mAP
    in the log, 0 K1 (SlowFast has no K1 conv)."""
    from contextlib import redirect_stdout

    from pmv_tpu_torch.data.loader import construct_loader
    from pmv_tpu_torch.tools import run_net

    t0 = time.perf_counter()
    write_charades(root)
    write_s = time.perf_counter() - t0
    out_dir = os.path.join(root, "run")
    argv = ["--cfg", CHARADES_CFG, "--opts", "DATA.PATH_TO_DATA_DIR", root,
            "DATA.PATH_PREFIX", os.path.join(root, "frames"), "NUM_GPUS", "1",
            "TRAIN.BATCH_SIZE", "8", "TEST.BATCH_SIZE", "8", "TRAIN.CHECKPOINT_FILE_PATH", "",
            "SOLVER.MAX_EPOCH", "1", "TEST.NUM_ENSEMBLE_VIEWS", "2", "OUTPUT_DIR", out_dir]
    cfg = run_net_cfg(argv)
    if not (cfg.DATA.MULTI_LABEL and cfg.MODEL.LOSS_FUNC == "bce_logit"
            and cfg.DATA.ENSEMBLE_METHOD == "max" and cfg.MODEL.NUM_CLASSES == 157
            and cfg.DATA.NUM_FRAMES == 64):
        raise AssertionError("the Charades yaml is not the multi-label recipe it was")
    tests = construct_loader(cfg, "test")
    with redirect_stdout(open(os.devnull, "w")):
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts()  # the main path starts here
        t0 = time.perf_counter()
        run_net.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_counts()  # ... and ends here
    with open(os.path.join(out_dir, "stdout.log")) as f:
        lines = f.read().splitlines()
    stats = [json.loads(line.split("json_stats: ", 1)[1])
             for line in lines if "json_stats: " in line]
    train = [s for s in stats if s.get("_type") == "train_epoch"]
    val = [s for s in stats if s.get("_type") == "val_epoch"]
    final = stats[-1]
    rec = {"phase": "charades_run_net", "card": card, "videos": CHARADES_VIDEOS,
           "frames_a_video": CHARADES_FRAMES, "write_s": write_s, "wall_s": wall,
           "test_clips": len(tests.dataset), "test_s": sum(
               s["time_diff"] for s in stats if s.get("split") == "test_iter"),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "train_epoch_stats": train, "val_epoch_stats": val,
           "final_stats": final}
    rec["test_clips_per_s"] = rec["test_clips"] / rec["test_s"]
    log(json.dumps(rec))
    if not (len(train) == 1 and np.isfinite(train[0]["loss"])):
        raise AssertionError(f"Charades trained no epoch of finite loss: {train}")
    if not (len(val) == 1 and 0.0 <= val[0].get("map", -1) <= 1.0):
        raise AssertionError(f"no eval epoch mAP in the Charades log: {val}")
    if not (final.get("split") == "test_final" and 0.0 <= final.get("map", -1) <= 1.0):
        raise AssertionError(f"no test_final mAP in the Charades log: {final}")
    if launches != eval_launches(0):
        raise AssertionError(f"Charades' SlowFast launched {launches}")
    return launches


# AVA action detection (configs/AVA/), phases 3a-6a.

AVA_CFGS = {name: os.path.join(ROOT, "configs", "AVA", f) for name, f in (
    ("slowfast", "SLOWFAST_32x2_R50_SHORT.yaml"), ("slow", "SLOW_8x8_R50_SHORT.yaml"))}
AVA_PARAMS = 33_828_888  # the JAX model's (tests/test_torch_port_detection.py)
AVA_K1 = 0  # SlowFast's and Slow's convs are dense
AVA_CPU_FRAMES = 8  # 3a's frames of the 32
AVA_VIDEOS = 8  # the dump's videos, 3 keyframes each
# The loader's threads in 6a: the card's host has 8 cores for its one card
# (the yamls' 2 are a process's of 8 on a host).
AVA_LOADER_THREADS = 8


def ava_cfg():
    """The SlowFast 32x2 AVA yaml as it is, NUM_GPUS 1."""
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(AVA_CFGS["slowfast"])
    cfg.NUM_GPUS = 1
    return cfg


def ava_batch(cfg, b, frames, rng):
    """``b`` keyframe clips of ``frames`` frames at the train crop with
    ``grad_witness.detection_boxes`` (16 slots, 3 valid, one at the edge)."""
    from pmv_tpu_torch.tools.grad_witness import detection_boxes

    size = cfg.DATA.TRAIN_CROP_SIZE
    return {"frames": rng.integers(0, 256, (b, frames, size, size, 3), np.uint8),
            **detection_boxes(b, size, cfg.MODEL.NUM_CLASSES, rng)}


def phase_ava_card_vs_cpu():
    """3a: full-width SlowFast 32x2 AVA at batch 2 on ``AVA_CPU_FRAMES`` of
    its 32 frames of 224^2, float32, card against CPU: the detection eval
    step, then one detection train step under phase 3s's gates and in
    float64 (``_train_step_card_vs_cpu``); 0 K1 each."""
    from pmv_tpu_torch.engine.steps import make_detection_eval_step

    cfg = ava_cfg()
    batch = ava_batch(cfg, 2, AVA_CPU_FRAMES, np.random.default_rng(13))
    n_params = sum(p.numel() for p in seeded_model(cfg, "meta", torch.float32).parameters())
    if n_params != AVA_PARAMS:
        raise AssertionError(f"SlowFast AVA has {n_params} parameters, not {AVA_PARAMS}")
    cpu_model, gpu_model = _models_card_and_cpu(cfg)
    args = (batch["frames"], batch["boxes"], batch["box_mask"])
    before = _launch_counts()
    t0 = time.perf_counter()
    gpu = make_detection_eval_step(cfg, gpu_model, device="cuda")(*args).cpu()
    gpu_s = time.perf_counter() - t0
    launches = _launches_since(before)
    t0 = time.perf_counter()
    cpu = make_detection_eval_step(cfg, cpu_model, device="cpu")(*args)
    cpu_s = time.perf_counter() - t0
    err = float((gpu - cpu).abs().max())
    padded = float(gpu[~torch.from_numpy(batch["box_mask"])].abs().max())
    log(json.dumps({"phase": "ava_full_model_f32_b2", "params": n_params,
                    "scores": list(gpu.shape), "max_abs_err_vs_cpu": err,
                    "padded_max_abs": padded, "launches": launches,
                    "gpu_first_call_s": gpu_s, "cpu_s": cpu_s}))
    if launches != eval_launches(AVA_K1):
        raise AssertionError(f"the AVA forward launched {launches}")
    if not torch.isfinite(gpu).all() or padded != 0.0:
        raise AssertionError("non-finite scores, or scores on padded boxes")
    torch.testing.assert_close(gpu, cpu, atol=1e-4, rtol=0)
    _train_step_card_vs_cpu("ava_train_step_f32_b2_card_vs_cpu", cfg, batch,
                            step_launches(AVA_K1), models=(cpu_model, gpu_model))


def phase_ava_serve(card, batches=4, batch=8):
    """4a, a main path: ``perform_detection`` over ``batches`` batches of
    ``batch`` keyframe clips (32 x 224^2, 3 boxes each) into a test
    ``AVAMeter`` in bfloat16, its groundtruth from the batches."""
    from pmv_tpu_torch.engine.steps import make_detection_eval_step
    from pmv_tpu_torch.engine.test import perform_detection
    from pmv_tpu_torch.utils.meters import AVAMeter

    cfg = ava_cfg()
    cfg.AVA.ANNOTATION_DIR = ""  # no files: the groundtruth from the batches
    model = seeded_model(cfg, "cuda")  # bfloat16 activations
    eval_step = make_detection_eval_step(cfg, model, device="cuda")
    rng = np.random.default_rng(4)
    size = cfg.DATA.TEST_CROP_SIZE
    loader = []
    for i in range(batches):
        b = ava_batch(cfg, batch, cfg.DATA.NUM_FRAMES, rng)
        b["ori_boxes"] = b["boxes"] / size
        b["metadata"] = np.stack([np.arange(i * batch, (i + 1) * batch),
                                  np.full(batch, 904)], axis=1)
        loader.append(b)
    eval_step(loader[0]["frames"], loader[0]["boxes"], loader[0]["box_mask"])  # warm-up
    torch.cuda.synchronize()
    meter = AVAMeter(len(loader), cfg, "test")
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    groundtruth = perform_detection(loader, eval_step, meter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    mean_ap = meter.finalize_metrics(log=False, groundtruth=groundtruth)
    n = batches * batch
    preds = np.concatenate(meter.all_preds)
    log(json.dumps({
        "phase": "ava_serve_bf16_b8", "card": card, "clips": n, "batches": batches,
        "boxes": int(preds.shape[0]), "wall_s": wall, "ms_per_batch": wall / batches * 1e3,
        "clips_per_s": n / wall, "map": mean_ap, "map_s": time.perf_counter() - t0,
        "max_memory_allocated_bytes": peak, "launches": launches}))
    if preds.shape != (3 * n, cfg.MODEL.NUM_CLASSES) or not np.isfinite(preds).all():
        raise AssertionError(f"bad detection scores: {preds.shape}")
    if not 0.0 <= mean_ap <= 1.0:
        raise AssertionError(f"AVA mAP {mean_ap}")
    if launches != eval_launches(AVA_K1):
        raise AssertionError(f"AVA serving launched {launches}")
    return launches


def ava_run_net_argv(name, root, out_dir, max_epoch, extra=()):
    """run_net's arguments: the yaml as it is, its data at the dump
    ``root``, NUM_GPUS 1, batch 8, ``AVA_LOADER_THREADS`` loader threads."""
    return ["--cfg", AVA_CFGS[name], "--opts",
            "AVA.FRAME_DIR", os.path.join(root, "frames"),
            "AVA.FRAME_LIST_DIR", os.path.join(root, "frame_lists"),
            "AVA.ANNOTATION_DIR", os.path.join(root, "annotations"),
            "NUM_GPUS", "1", "TRAIN.BATCH_SIZE", "8", "TEST.BATCH_SIZE", "8",
            "DATA_LOADER.NUM_WORKERS", str(AVA_LOADER_THREADS),
            "SOLVER.MAX_EPOCH", str(max_epoch), "OUTPUT_DIR", out_dir, *extra]


def _ava_run_net_call(name, root, out_dir, max_epoch, extra):
    """One ``run_net`` call on an AVA yaml (a main path), read from its log:
    the epoch's, the eval's, the checkpoint's and the test's seconds, the
    val epoch's and the test's AVA mAP, the checkpoint's bytes."""
    from pmv_tpu_torch.data.loader import construct_loader
    from pmv_tpu_torch.tools import run_net

    argv = ava_run_net_argv(name, root, out_dir, max_epoch, extra)
    cfg = run_net_cfg(argv)
    train_steps = len(construct_loader(cfg, "train"))
    log_path = os.path.join(out_dir, "stdout.log")
    skip = 0
    if os.path.exists(log_path):
        with open(log_path) as f:
            skip = len(f.read().splitlines())
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    run_net.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()  # ... and ends here
    with open(log_path) as f:
        lines = f.read().splitlines()[skip:]
    stats = [json.loads(line.split("json_stats: ", 1)[1])
             for line in lines if "json_stats: " in line]
    train = [s for s in stats if s.get("_type") == "train_epoch"]
    val = [s for s in stats if s.get("_type") == "val_epoch"]
    final = stats[-1]
    if not (len(train) == 1 and np.isfinite(train[0]["loss"])):
        raise AssertionError(f"AVA {name} trained no epoch of finite loss: {train}")
    if not (len(val) == 1 and 0.0 <= val[0]["map"] <= 1.0):
        raise AssertionError(f"no val epoch mAP in the AVA {name} log: {val}")
    if not (final.get("split") == "test_final" and 0.0 <= final.get("map", -1) <= 1.0):
        raise AssertionError(f"no test_final mAP in the AVA {name} log: {final}")
    if launches != eval_launches(AVA_K1):
        raise AssertionError(f"AVA {name}'s run_net launched {launches}")
    epoch = max_epoch - 1
    saved = _last_match(lines, r"Saved checkpoint to (\S+) in ([\d.]+)s")
    tested = _last_match(lines, r"AVA test: (\d+) keyframes in ([\d.]+)s")
    return {
        "phase": f"ava_run_net_{name}_epoch_{max_epoch}", "wall_s": wall,
        "epoch_s": float(_last_match(lines, rf"Epoch {epoch} takes ([\d.]+)s")[1]),
        "train_steps": train_steps, "train_clips": 8 * train_steps,
        "eval_s": float(_last_match(lines, rf"Eval of epoch {epoch} takes ([\d.]+)s")[1]),
        "test_keyframes": int(tested[1]), "test_s": float(tested[2]),
        "checkpoint": saved[1], "checkpoint_s": float(saved[2]),
        "checkpoint_bytes": os.path.getsize(saved[1]),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "train_epoch_stats": train[0], "val_map": val[0]["map"],
        "test_map": final["map"], "log": lines,
    }


def phase_ava_run_net(card, root):
    """6a, main paths: the dump (``tools/ava_dump.py``, ``AVA_VIDEOS``
    videos), then on each AVA yaml ``run_net`` for one epoch, the restore,
    every tensor compared, and the resume with SOLVER.MAX_EPOCH 2;
    SlowFast's first call from a Kinetics SlowFast ``.pyth`` (the
    projection alone keeps its init). Returns the launches of each call."""
    from contextlib import redirect_stdout

    from pmv_tpu_torch.tools.ava_dump import write_ava_dump

    t0 = time.perf_counter()
    keyframes = write_ava_dump(root, videos=AVA_VIDEOS)
    kinetics = os.path.join(root, "kinetics_slowfast_8x8_r50.pyth")
    torch.save({"model_state": seeded_model(slowfast_cfg(), "cpu", torch.float32).state_dict()},
               kinetics)
    log(json.dumps({"phase": "ava_dump", "keyframes": len(keyframes),
                    "seconds": time.perf_counter() - t0}))
    launches = []
    for name in ("slowfast", "slow"):
        out_dir = os.path.join(root, f"run_{name}")
        extra = ["TRAIN.CHECKPOINT_TYPE", "pytorch",
                 "TRAIN.CHECKPOINT_FILE_PATH", kinetics if name == "slowfast" else ""]
        with redirect_stdout(open(os.devnull, "w")):
            first = _ava_run_net_call(name, root, out_dir, 1, extra)
            restored = check_restore(run_net_cfg(ava_run_net_argv(name, root, out_dir, 2, extra)))
            second = _ava_run_net_call(name, root, out_dir, 2, extra)
        if name == "slowfast":  # train()'s load, the first (test() loads the run's own)
            loaded = next(m for m in map(re.compile(
                r"Loaded (\d+) of the model's (\d+) tensors from the checkpoint; (\d+) kept "
                r"their init").search, first["log"]) if m)
            first["kinetics_load"] = loaded[0]
            if int(loaded[3]) != 2 or not any("Dropping head.projection.weight" in line
                                              for line in first["log"]):
                raise AssertionError(f"the Kinetics SlowFast did not load as the trunk: {loaded[0]}")
        if restored["start_epoch"] != 1 or restored["checkpoint"] != first["checkpoint"]:
            raise AssertionError(f"the AVA {name} restore did not start after epoch 1")
        if not any(f"Load from last checkpoint, {first['checkpoint']}." in line
                   for line in second["log"]):
            raise AssertionError(f"the second AVA {name} call did not resume")
        for rec in (first, second):
            rec.pop("log")
            log(json.dumps({**rec, "card": card}))
        log(json.dumps({"phase": f"ava_run_net_{name}_restore", **restored}))
        launches += [first["launches"], second["launches"]]
    return launches


# MaskFeat pre-training of MViTv2-S 16x4 (configs/masked_ssl/), phases 3m-7m.


def maskfeat_cfg():
    """The MaskFeat PT yaml at full width (16 blocks, 16 frames of 224^2, HOG
    targets), one process."""
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(MASKFEAT_PT_CFG)
    cfg.NUM_GPUS = 1
    cfg.TRAIN.BATCH_SIZE = MASKFEAT_BATCH
    return cfg


def _maskfeat_clip(cfg):
    """A clip's shape [T, S, S, 3] at the config's train crop."""
    size = cfg.DATA.TRAIN_CROP_SIZE
    return (cfg.DATA.NUM_FRAMES, size, size, 3)


def _token_otherwise(otherwise, model):
    """Per patch token, whether any pixel of its HOG cells (its frames,
    rows, columns and channels) took another bin: [B, n_tok] bool."""
    b, t, h, w, c = otherwise.shape
    pt, ph, pw = model.patch
    t_tok, h_tok, w_tok = model.token_grid(otherwise.shape)
    grid = otherwise.reshape(b, t_tok, t // t_tok, h_tok, ph, w_tok, pw, c)
    return grid.any(dim=7).any(dim=6).any(dim=4).any(dim=2).reshape(b, -1)


def phase_maskfeat_card_vs_cpu():
    """3m: full-width MaskMViT in float32, card against CPU from one seeded
    init: the forward at batch 1 with one mask from a seed (pred to atol
    1e-4; target, with the CPU's HOG bins held, to 1e-5, and the card's own
    target to 1e-5 on every token whose pixels both sides binned alike; the
    pixels binned otherwise counted), 14 K1 launches; then one AdamW step at
    batch 2 (the PT recipe, the gradient clipped at 0.02) from the same
    draws and held bins: loss and grad norm to 1e-4 and weights within 2 x
    lr of the CPU's, 28 K1 and 14 wgrad launches; and the card's step again
    from the same weights with each max pool taking the CPU step's taps
    (``grad_witness.max_pool_decisions``, as the bins are held): its
    gradients to 1e-4 (relative L2) of the CPU's, its grad norm to 1e-4.
    The gradients as the card takes its own taps, and the count of taps
    taken otherwise, are printed. The count of weights off the CPU's by
    more than 1e-6 is printed: under the 0.02 clip many gradient elements
    are of the order of Adam's epsilon, where the update moves with the
    gradient's last bits."""
    from pmv_tpu_torch.engine.ssl_steps import init_masked_state, make_masked_train_step
    from pmv_tpu_torch.engine.steps import make_preprocess_fn
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.models.masked import hog_bins
    from pmv_tpu_torch.tools.grad_witness import max_pool_decisions

    cfg = maskfeat_cfg()
    lr = cfg.SOLVER.BASE_LR
    cpu_model, gpu_model = _models_card_and_cpu(cfg)
    n_params = sum(p.numel() for p in gpu_model.parameters())
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (1, *_maskfeat_clip(cfg)), np.uint8)
    mask = cpu_model.sample_mask(frames.shape, torch.Generator().manual_seed(7))
    preprocess = {d: make_preprocess_fn(cfg, train=False, device=d) for d in ("cpu", "cuda")}
    x_cpu = preprocess["cpu"](torch.as_tensor(frames))
    x_gpu = preprocess["cuda"](torch.as_tensor(frames, device="cuda"))
    bins_cpu = hog_bins(x_cpu)
    otherwise = hog_bins(x_gpu).cpu() != bins_cpu
    cpu_model.eval()
    gpu_model.eval()
    with torch.no_grad():
        counts = _launch_counts()
        gpred, gtarget, _ = gpu_model(x_gpu, mask.cuda(), hog_bins=bins_cpu)
        launches = _launches_since(counts)
        own_target = gpu_model.targets(x_gpu).cpu()
        cpred, ctarget, _ = cpu_model(x_cpu, mask)
    gpred, gtarget = gpred.cpu(), gtarget.cpu()
    alike = ~_token_otherwise(otherwise, cpu_model)
    own_err = float((own_target - ctarget)[alike].abs().max())
    log(json.dumps({
        "phase": "maskfeat_forward_f32_b1_card_vs_cpu", "model": cfg.MODEL.MODEL_NAME,
        "params": n_params, "params_jax": MASKFEAT_PARAMS, "launches": launches,
        "masked_tokens": int(mask.sum()), "tokens": mask.numel(),
        "pred_max_abs_err": float((gpred - cpred).abs().max()),
        "target_bins_held_max_abs_err": float((gtarget - ctarget).abs().max()),
        "pixels_binned_otherwise": int(otherwise.sum()), "pixels": otherwise.numel(),
        "tokens_binned_otherwise": int((~alike).sum()),
        "target_own_bins_max_abs_err_where_alike": own_err,
    }))
    if n_params != MASKFEAT_PARAMS:
        raise AssertionError(f"MaskMViT has {n_params} parameters, the JAX model "
                             f"{MASKFEAT_PARAMS}")
    if launches != eval_launches(MASKFEAT_K1):
        raise AssertionError(f"one MaskMViT forward launched {launches}, not {MASKFEAT_K1} K1")
    if not (torch.isfinite(gpred).all() and torch.isfinite(gtarget).all()):
        raise AssertionError("non-finite MaskMViT outputs on the card")
    torch.testing.assert_close(gpred, cpred, atol=1e-4, rtol=0)
    torch.testing.assert_close(gtarget, ctarget, atol=1e-5, rtol=0)
    if own_err > 1e-5:
        raise AssertionError(f"the card's own HOG targets differ by {own_err} where every "
                             "pixel was binned alike")

    batch = {"frames": rng.integers(0, 256, (2, *_maskfeat_clip(cfg)), np.uint8)}
    cpu_state, gpu_state = init_masked_state(cfg, cpu_model), init_masked_state(cfg, gpu_model)
    cpu_step = make_masked_train_step(cfg, device="cpu", seed=0)
    gpu_step = make_masked_train_step(cfg, device="cuda", seed=0)
    draws = cpu_step.sample_draws(cpu_model, batch["frames"].shape)
    train_pre = {d: make_preprocess_fn(cfg, train=True, device=d) for d in ("cpu", "cuda")}
    draws["hog_bins"] = hog_bins(train_pre["cpu"](torch.as_tensor(batch["frames"]), draws))
    x_train = train_pre["cuda"](torch.as_tensor(batch["frames"], device="cuda"), draws)
    step_otherwise = int((hog_bins(x_train).cpu() != draws["hog_bins"]).sum())
    before = {k: v.detach().clone() for k, v in cpu_model.state_dict().items()}
    counts = _launch_counts()
    t0 = time.perf_counter()
    gpu = {k: v.cpu() for k, v in gpu_step(gpu_state, batch, lr, draws).items()}
    gpu_s = time.perf_counter() - t0
    launches = _launches_since(counts)
    t0 = time.perf_counter()
    with max_pool_decisions() as cpu_decisions:
        cpu = cpu_step(cpu_state, batch, lr, draws)
    cpu_s = time.perf_counter() - t0
    # The card's step again from the same weights, each max pool (the skip
    # pools of blocks 1 and 3) taking the CPU step's taps: two taps within a
    # rounding of each other move the gradients of everything before the
    # pool (PERF.md; tools/op_witness.py).
    held_model = build_model(cfg, device="cuda", dtype=torch.float32, seed=0)
    held_model.load_state_dict(before, strict=True)
    with max_pool_decisions(cpu_decisions) as card_decisions:
        held = gpu_step(init_masked_state(cfg, held_model), batch, lr, draws)
    cpu_grads, gpu_grads, held_grads = _grads(cpu_model), _grads(gpu_model), _grads(held_model)
    grad_rel = _grad_rel_err(held_grads, cpu_grads)
    worst = sorted((float((held_grads[k] - v).norm()), k, float(v.norm()),
                    float((gpu_grads[k] - v).norm())) for k, v in cpu_grads.items())[-3:]
    params_gpu = {k: v.detach().cpu() for k, v in gpu_model.named_parameters()}
    params_cpu = {k: v.detach() for k, v in cpu_model.named_parameters()}
    param_err = max(float((params_gpu[k] - v).abs().max()) for k, v in params_cpu.items())
    n_off = sum(int(((params_gpu[k] - v).abs() > 1e-6).sum()) for k, v in params_cpu.items())
    moved = sum(int((v != before[k]).sum()) for k, v in params_cpu.items())
    log(json.dumps({
        "phase": "maskfeat_train_step_f32_b2_card_vs_cpu", "model": cfg.MODEL.MODEL_NAME,
        "frames": list(batch["frames"].shape), "lr": lr,
        "clip_grad_l2norm": cfg.SOLVER.CLIP_GRAD_L2NORM, "launches": launches,
        "loss": [float(gpu["loss"]), float(cpu["loss"])],
        "grad_norm": [float(gpu["grad_norm"]), float(cpu["grad_norm"]),
                      float(held["grad_norm"])],
        "grad_rel_err_max_pools_held": grad_rel,
        "grad_rel_err_own_max_pools": _grad_rel_err(gpu_grads, cpu_grads),
        "max_pool_outputs": sum(int(m.numel()) for m in cpu_decisions.masks),
        "card_max_pool_taps_otherwise": card_decisions.taken_otherwise,
        "grads_furthest_apart": [{"param": n, "held_l2_diff": d, "grad_l2": g,
                                  "own_l2_diff": o} for d, n, g, o in worst],
        "param_max_abs_err": param_err, "params_off_by_1e-6": n_off, "params": n_params,
        "params_moved": moved, "pixels_binned_otherwise": step_otherwise,
        "gpu_first_call_s": gpu_s, "cpu_s": cpu_s,
    }))
    if launches != step_launches(MASKFEAT_K1):
        raise AssertionError(f"one MaskMViT train step launched {launches}, not "
                             f"{step_launches(MASKFEAT_K1)}")
    torch.testing.assert_close(gpu["loss"], cpu["loss"], atol=0, rtol=1e-4)
    torch.testing.assert_close(gpu["grad_norm"], cpu["grad_norm"], atol=0, rtol=1e-4)
    torch.testing.assert_close(held["grad_norm"].cpu(), cpu["grad_norm"], atol=0, rtol=1e-4)
    if bool(gpu["nan"]) or bool(cpu["nan"]):
        raise AssertionError("a non-finite MaskFeat loss")
    if grad_rel > 1e-4:
        raise AssertionError(f"with the CPU's max-pool taps MaskMViT's card gradients lie "
                             f"{grad_rel} from the CPU's (relative L2)")
    if param_err > 2.0001 * lr:
        raise AssertionError(f"updated parameters differ by {param_err}, over 2 x lr")
    if moved < 0.5 * n_params:
        raise AssertionError(f"only {moved} of {n_params} weights moved")


def maskfeat_kernel_ms(records):
    """ms of K1 (forward and dx) and of the wgrad kernel in one bf16 train
    step at batch 8 at the PT yaml's shapes (``MASKFEAT_POOL_SHAPES``, the
    phase 2 records of those shapes), per key."""
    from pmv_tpu_torch.ops.depthwise import MASKFEAT_POOL_SHAPES

    def summed(kernel, key):
        total = 0.0
        for shape, n in MASKFEAT_POOL_SHAPES:
            rec = next(r for r in records if r["kernel"] == kernel and r["dtype"] == "bfloat16"
                       and r["grid"] == "square" and tuple(r["shape"]) == tuple(shape))
            total += n * rec[key]
        return total

    keys = ("kernel_ms", "kernel_warm_ms", "plain_ms", "bound_ms", "library_ms")
    return {kernel: {key: summed(kernel, key) for key in keys}
            for kernel in ("depthwise3x3x3", "depthwise3x3x3_wgrad")}


def phase_maskfeat_step(card, records):
    """4m: the bf16 masked train step at batch 8, the model drawing its
    masks, timed alone (2 warm-up steps, then 5 between synchronizes): ms a
    step, clips/s, peak memory, its K1 and wgrad launches and their share of
    the step (phase 2's ms at these shapes, from ``records``: K1 twice,
    forward and dx)."""
    from pmv_tpu_torch.engine.ssl_steps import init_masked_state, make_masked_train_step

    cfg = maskfeat_cfg()
    model = seeded_model(cfg, "cuda")  # bfloat16 activations
    state = init_masked_state(cfg, model)
    step = make_masked_train_step(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(8)
    batch = {"frames": torch.randint(0, 256, (MASKFEAT_BATCH, *_maskfeat_clip(cfg)),
                                     dtype=torch.uint8, device="cuda", generator=gen)}
    for _ in range(2):
        step(state, batch, cfg.SOLVER.BASE_LR)
    torch.cuda.synchronize()
    timed = 5
    torch.cuda.reset_peak_memory_stats()
    counts = _launch_counts()
    t0 = time.perf_counter()
    losses = [step(state, batch, cfg.SOLVER.BASE_LR)["loss"] for _ in range(timed)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed * 1e3
    launches = _launches_since(counts)
    peak = torch.cuda.max_memory_allocated()
    rec = {"phase": "maskfeat_step_bf16_b8", "card": card, "batch": MASKFEAT_BATCH,
           "steps": timed, "ms_per_step": ms, "clips_per_s": MASKFEAT_BATCH / ms * 1e3,
           "max_memory_allocated_bytes": peak, "launches": launches,
           "losses": [float(v) for v in losses]}
    kernels = maskfeat_kernel_ms(records)
    k1_ms = 2 * kernels["depthwise3x3x3"]["kernel_ms"]
    wgrad_ms = kernels["depthwise3x3x3_wgrad"]["kernel_ms"]
    rec.update(k1_ms_per_step=k1_ms, wgrad_ms_per_step=wgrad_ms, k1_share=k1_ms / ms,
               wgrad_share=wgrad_ms / ms)
    log(json.dumps(rec))
    losses = rec["losses"]
    if launches != {k: n * timed for k, n in step_launches(MASKFEAT_K1).items()}:
        raise AssertionError(f"{timed} masked steps launched {launches}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite MaskFeat losses {losses}")


def phase_maskfeat_train(card):
    """5m, a main path: 2 steps of ``train_ssl``'s loop body
    (``train_epoch`` over the masked step) on synthetic batch-8 clips in
    bfloat16, after one warm-up step; counts zeroed just before the 2 and
    read just after."""
    from pmv_tpu_torch.engine.ssl_steps import init_masked_state, make_masked_train_step
    from pmv_tpu_torch.engine.train import train_epoch
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.utils.meters import TrainMeter

    cfg = maskfeat_cfg()
    timed = 2
    cfg.LOG_PERIOD = timed
    cfg.SOLVER.MAX_EPOCH = 1
    model = build_model(cfg, device="cuda", seed=0)
    state = init_masked_state(cfg, model)
    step = make_masked_train_step(cfg, device="cuda", seed=0)
    metrics = []

    def recording_step(state, batch, lr):
        m = step(state, batch, lr)
        metrics.append(m)
        return m

    rng = np.random.default_rng(9)
    loader = [{"frames": rng.integers(0, 256, (MASKFEAT_BATCH, *_maskfeat_clip(cfg)), np.uint8)}
              for _ in range(1 + timed)]
    train_epoch(loader[:1], recording_step, state, TrainMeter(1, cfg), 0, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    train_epoch(loader[1:], recording_step, state, TrainMeter(timed, cfg), 0, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()  # ... and ends here
    losses = [float(m["loss"]) for m in metrics]
    grad_norms = [float(m["grad_norm"]) for m in metrics]
    log(json.dumps({
        "phase": "maskfeat_train_epoch_bf16_b8", "card": card, "steps": timed,
        "batch": MASKFEAT_BATCH, "wall_s": wall, "ms_per_step": wall / timed * 1e3,
        "clips_per_s": timed * MASKFEAT_BATCH / wall,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "losses": losses, "grad_norms": grad_norms,
        "steps_taken": state.step,
    }))
    if not np.all(np.isfinite(losses + grad_norms)):
        raise AssertionError(f"non-finite losses {losses} or grad norms {grad_norms}")
    if launches != {k: n * timed for k, n in step_launches(MASKFEAT_K1).items()}:
        raise AssertionError(f"{timed} masked steps launched {launches}")
    return launches


def maskfeat_pt_argv(out_dir, max_epoch):
    """run_net's arguments for the PT yaml: one process, batch 8, the
    Synthetic dataset (no loader mask: the model draws its own)."""
    return ["--cfg", MASKFEAT_PT_CFG, "--opts", "NUM_GPUS", "1",
            "TRAIN.BATCH_SIZE", str(MASKFEAT_BATCH), "TRAIN.DATASET", "synthetic",
            "SOLVER.MAX_EPOCH", str(max_epoch), "OUTPUT_DIR", out_dir]


def _maskfeat_pt_call(out_dir, max_epoch):
    """One PT ``run_net`` call (a main path): its launches, wall time, the
    train stats and the checkpoint it wrote, from its own log."""
    from pmv_tpu_torch.data.loader import construct_loader
    from pmv_tpu_torch.tools import run_net

    argv = maskfeat_pt_argv(out_dir, max_epoch)
    steps = len(construct_loader(run_net_cfg(argv), "train"))
    log_path = os.path.join(out_dir, "stdout.log")
    skip = 0
    if os.path.exists(log_path):
        with open(log_path) as f:
            skip = len(f.read().splitlines())
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    run_net.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()  # ... and ends here
    with open(log_path) as f:
        lines = f.read().splitlines()[skip:]
    stats = [json.loads(line.split("json_stats: ", 1)[1])
             for line in lines if "json_stats: " in line]
    train_stats = [s for s in stats if s.get("_type") == "train_epoch"][-1]
    if not np.isfinite(train_stats["loss"]):
        raise AssertionError(f"non-finite MaskFeat train loss {train_stats}")
    expected = {k: n * steps for k, n in step_launches(MASKFEAT_K1).items()}
    if launches != expected:
        raise AssertionError(f"the PT run_net launched {launches}, not {expected}")
    saved = _last_match(lines, r"Saved checkpoint to (\S+) in ([\d.]+)s")
    return {
        "phase": f"maskfeat_run_net_pt_epoch_{max_epoch}", "wall_s": wall,
        "train_steps": steps, "train_clips": steps * MASKFEAT_BATCH,
        "train_clips_per_s_of_wall": steps * MASKFEAT_BATCH / wall,
        "checkpoint": saved[1], "checkpoint_s": float(saved[2]),
        "checkpoint_bytes": os.path.getsize(saved[1]),
        "optimizer_steps": torch.load(saved[1], map_location="cpu", weights_only=True)[
            "optimizer_state"]["param_groups"][0]["count"],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "train_epoch_stats": train_stats, "log": lines,
    }


def phase_maskfeat_run_net(card, out_dir):
    """6m: ``run_net`` on the PT yaml for one epoch (train_ssl, its
    checkpoint); the restore as train_ssl restores it, every weight and
    AdamW tensor compared with the file's; ``run_net`` again with
    SOLVER.MAX_EPOCH 2, which must resume. Returns (both calls' launches,
    the last checkpoint)."""
    from contextlib import redirect_stdout

    from pmv_tpu_torch.engine.ssl_steps import init_masked_state
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.utils import checkpoint as cu

    with redirect_stdout(open(os.devnull, "w")):
        first = _maskfeat_pt_call(out_dir, 1)
        cfg = run_net_cfg(maskfeat_pt_argv(out_dir, 2))
        state = init_masked_state(cfg, build_model(cfg, device="cuda", seed=cfg.RNG_SEED))
        last = cu.get_last_checkpoint(cfg.OUTPUT_DIR, cfg.TASK)
        start = cu.load_checkpoint(last, state) + 1
        restored = {"checkpoint": last, **_compare_restored(
            state, torch.load(last, map_location="cpu", weights_only=True), start)}
        second = _maskfeat_pt_call(out_dir, 2)
    if restored["start_epoch"] != 1 or restored["checkpoint"] != first["checkpoint"]:
        raise AssertionError(f"the MaskFeat restore did not start after epoch 1: {restored}")
    if not (any(f"Resumed SSL training from {first['checkpoint']}" in line
                for line in second["log"])
            and any("Start epoch: 2" in line for line in second["log"])):
        raise AssertionError("the second PT call did not resume from the first's checkpoint")
    if second["optimizer_steps"] != first["optimizer_steps"] + second["train_steps"]:
        raise AssertionError(f"the PT optimizer took {second['optimizer_steps']} steps in all")
    for rec in (first, second):
        rec.pop("log")
        log(json.dumps({**rec, "card": card}))
    log(json.dumps({"phase": "maskfeat_run_net_restore", **restored}))
    return [first["launches"], second["launches"]], second["checkpoint"]


def phase_maskfeat_fine_tune(card, pt_checkpoint, out_dir):
    """7m: the FT yaml from the PT checkpoint with CLEAR_NAME_PATTERN
    ["backbone."]: first the load as ``train()`` makes it, every FT tensor
    equal to the checkpoint's ``backbone.`` tensor of its name and shape,
    the others to their init, no optimizer state, epoch 0; then ``run_net``
    (float32, as the yaml sets; 4 videos of 2 clips a step; eval; a 1-view
    test), a main path. Returns its launches."""
    from contextlib import redirect_stdout

    from pmv_tpu_torch.engine.steps import init_state
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.utils import checkpoint as cu

    extra = ["TRAIN.BATCH_SIZE", "4", "TRAIN.CHECKPOINT_FILE_PATH", pt_checkpoint]
    cfg = run_net_cfg(run_net_argv("maskfeat_ft", out_dir, 1) + extra)
    model = build_model(cfg, device="cuda", seed=cfg.RNG_SEED)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    state = init_state(cfg, model)
    with redirect_stdout(open(os.devnull, "w")):
        start = cu.load_train_checkpoint(cfg, state)
    pt = torch.load(pt_checkpoint, map_location="cpu", weights_only=True)["model_state"]
    loaded, kept = [], []
    for name, value in model.state_dict().items():
        src = pt.get("backbone." + name)
        if src is not None and src.shape == value.shape:
            if not torch.equal(value.cpu(), src):
                raise AssertionError(f"FT {name} differs from the PT checkpoint's")
            loaded.append(name)
        else:
            if not torch.equal(value.cpu(), init[name]):
                raise AssertionError(f"FT {name} moved from its init")
            kept.append(name)
    backbone = [k for k in pt if k.startswith("backbone.")]
    rec = {"phase": "maskfeat_fine_tune_load", "start_epoch": start,
           "tensors_loaded": len(loaded), "tensors_kept_init": len(kept), "kept": kept,
           "pt_backbone_tensors": len(backbone), "optimizer_state": len(state.optimizer.state)}
    log(json.dumps(rec))
    if start != 0 or state.step != 0 or state.optimizer.state:
        raise AssertionError(f"the FT load took the PT run's epoch or optimizer: {rec}")
    if not loaded or any(k.startswith("blocks.0.") for k in kept):
        raise AssertionError(f"the FT load left backbone tensors at their init: {kept}")
    with redirect_stdout(open(os.devnull, "w")):
        ft = _run_net_call("maskfeat_ft", out_dir, 1, extra)
    ft.pop("log")
    log(json.dumps({**ft, "card": card}))
    return ft["launches"]


def phase_maskfeat_vis_mask(card, out_dir):
    """VIS_MASK, a main path: ``run_net`` with the MAE variant of the PT yaml
    (MASK.PRED_HOG False) at TEST.BATCH_SIZE 2, TRAIN off, TEST and
    VIS_MASK on: 4 batches, each's (original | masked | reconstructed)
    stack written and checked (uint8, the original plane equal to the
    Synthetic clip's frames of every temporal patch). Returns its launches."""
    from contextlib import redirect_stdout

    from pmv_tpu_torch.data.synthetic import Synthetic
    from pmv_tpu_torch.tools import run_net

    argv = ["--cfg", MASKFEAT_PT_CFG, "--opts", "NUM_GPUS", "1", "TRAIN.ENABLE", "False",
            "TEST.ENABLE", "True", "VIS_MASK.ENABLE", "True", "MASK.PRED_HOG", "False",
            "TEST.BATCH_SIZE", "2", "TEST.DATASET", "synthetic", "TEST.NUM_TEMPORAL_CLIPS", "[]",
            "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1", "OUTPUT_DIR", out_dir]
    _zero_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    with redirect_stdout(open(os.devnull, "w")):
        run_net.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()  # ... and ends here
    paths = sorted(p for p in os.listdir(out_dir) if p.startswith("vis_mask_"))
    comp = np.load(os.path.join(out_dir, paths[0]))
    cfg = run_net_cfg(argv)
    frames = Synthetic(cfg, "test")[0]["frames"]
    size = cfg.DATA.TEST_CROP_SIZE
    log(json.dumps({"phase": "maskfeat_vis_mask_bf16_b2", "card": card, "wall_s": wall,
                    "stacks": paths, "shape": list(comp.shape), "launches": launches}))
    if len(paths) != 4 or comp.dtype != np.uint8 or comp.shape != (
            2, 3, cfg.DATA.NUM_FRAMES // 2, size, size, 3):
        raise AssertionError(f"VIS_MASK wrote {paths}, of shape {comp.shape}")
    if not np.array_equal(comp[0, 0], frames[::2]):
        raise AssertionError("the VIS_MASK original plane is not the clip's frames")
    if launches != eval_launches(4 * MASKFEAT_K1):
        raise AssertionError(f"VIS_MASK launched {launches}, not 4 x {MASKFEAT_K1} K1")
    return launches


# Contrastive SSL (configs/contrastive_ssl/) on Slow R50, phases 3c-6c and 8d.

SSL_CFGS = {name: os.path.join(ROOT, "configs", "contrastive_ssl", f) for name, f in (
    ("moco", "MoCo_SlowR50_8x8.yaml"), ("simclr", "SimCLR_SlowR50_8x8.yaml"),
    ("byol", "BYOL_SlowR50_8x8.yaml"), ("swav", "SwAV_Slow_R50_8x8.yaml"))}
# The JAX ContrastiveEncoder's parameter count of each yaml (its
# ``build_model``; tests/test_torch_port_contrastive.py holds the port to it).
SSL_PARAMS = {"moco": 40_289_472, "simclr": 40_289_472, "byol": 41_076_032,
              "swav": 40_289_472}
SSL_BATCH = 8  # videos a bf16 contrastive step (phases 4c-6c), two views each


def ssl_cfg(name):
    """A published contrastive yaml in one process (the yamls say 8)."""
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(SSL_CFGS[name])
    cfg.NUM_GPUS = 1
    return cfg


def contrastive_x3d_cfg():
    """X3D-M (configs/Kinetics/X3D_M.yaml) as a ContrastiveModel's backbone,
    with the SimCLR yaml's contrastive options, colour jitter and LARS."""
    cfg, simclr = x3d_cfg(), ssl_cfg("simclr")
    cfg.MODEL.MODEL_NAME = "ContrastiveModel"
    cfg.MODEL.NUM_CLASSES = simclr.MODEL.NUM_CLASSES
    cfg.CONTRASTIVE = simclr.CONTRASTIVE
    for key in ("COLOR_RND_GRAYSCALE", "SSL_COLOR_BRI_CON_SAT", "SSL_COLOR_HUE",
                "SSL_COLOR_JITTER", "SSL_MOCOV2_AUG"):
        cfg.DATA[key] = simclr.DATA[key]
    for key in ("BASE_LR", "LARS_ON", "WEIGHT_DECAY"):
        cfg.SOLVER[key] = simclr.SOLVER[key]
    return cfg


def _ssl_batch(cfg, seed, b=2, views=2):
    """b videos of ``views`` uint8 views (the loader's [B, V, T, H, W, C])
    and their sample indices."""
    rng = np.random.default_rng(seed)
    size = cfg.DATA.TRAIN_CROP_SIZE
    frames = rng.integers(0, 256, (b, views, cfg.DATA.NUM_FRAMES, size, size, 3), np.uint8)
    return {"frames": frames, "index": np.arange(b, dtype=np.int64) * 1000 + 7}


def _ssl_models_card_and_cpu(cfg, dtype):
    """``_models_card_and_cpu`` with the queue and the bank filled with unit
    rows from a seed (the loss reads them) and the queue's pointer one row
    from its end (the enqueue wraps)."""
    cpu_model, gpu_model = _models_card_and_cpu(cfg, dtype)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name in ("queue", "bank"):
            if hasattr(cpu_model, name):
                t = getattr(cpu_model, name)
                t.copy_(torch.nn.functional.normalize(torch.randn(t.shape, generator=gen), dim=1))
        if hasattr(cpu_model, "queue_ptr"):
            cpu_model.queue_ptr.fill_(cpu_model.queue.shape[0] - 1)
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    return cpu_model, gpu_model


def _update_rel_err(got, want, before):
    """Relative L2 distance of the weights' updates (after - before)."""
    diff = sum(float(((got[k] - before[k]) - (v - before[k])).square().sum())
               for k, v in want.items())
    return (diff / max(sum(float((v - before[k]).square().sum()) for k, v in want.items()),
                       1e-30)) ** 0.5


def _ssl_step_card_vs_cpu(phase, cfg, batch, expected, dtype=torch.float32):
    """One contrastive train step on the card and on the CPU from the same
    weights, SSL state and draws, activations in ``dtype``; raises unless
    they agree and the card's step launched ``expected``. Gates: the loss to
    1e-4; the gradients, the weights' updates (relative L2) and the grad
    norm to 1e-4, the BatchNorm running statistics to rtol 1e-4, the
    momentum encoder, the queue and the bank to 1e-4 (absolute), the
    queue's pointer equal. For a backbone in ``grad_witness.RELU_LIMITS`` in
    float32 the gradients and updates to its limit and the grad norm
    printed, then the card's step again with each ReLU taking the CPU's
    decisions, both to 1e-4; for one in ``FLOAT64_HELD`` (Slow) the held
    readings and the float32 statistics printed, and the step again in
    float64 on both sides under every gate."""
    from pmv_tpu_torch.engine.ssl_steps import init_ssl_state, make_ssl_train_step
    from pmv_tpu_torch.tools.grad_witness import (
        FLOAT64_HELD, RELU_LIMITS, relu_decisions, witness_key)

    key = witness_key(cfg)
    free = dtype == torch.float32 and key in RELU_LIMITS
    lr = cfg.SOLVER.BASE_LR
    cpu_model, gpu_model = _ssl_models_card_and_cpu(cfg, dtype)
    before = {k: v.detach().clone() for k, v in cpu_model.state_dict().items()}
    cpu_step = make_ssl_train_step(cfg, device="cpu", seed=0)
    gpu_step = make_ssl_train_step(cfg, device="cuda", seed=0)
    view = batch["frames"].shape[:1] + batch["frames"].shape[2:]
    draws = cpu_step.sample_draws(view)
    counts = _launch_counts()
    t0 = time.perf_counter()
    gpu = {k: v.cpu() for k, v in gpu_step(init_ssl_state(cfg, gpu_model), batch, lr,
                                           draws).items()}
    gpu_s = time.perf_counter() - t0
    launches = _launches_since(counts)
    t0 = time.perf_counter()
    with relu_decisions() as cpu_decisions:
        cpu = cpu_step(init_ssl_state(cfg, cpu_model), batch, lr, draws)
    cpu_s = time.perf_counter() - t0

    cpu_grads, gpu_grads = _grads(cpu_model), _grads(gpu_model)
    got = {k: v.detach().cpu() for k, v in gpu_model.state_dict().items()}
    want = {k: v.detach() for k, v in cpu_model.state_dict().items()}
    params = [k for k, _ in cpu_model.named_parameters()]
    ssl = [k for k in want if k.startswith("momentum.") or k in ("queue", "bank")]
    grad_limit = RELU_LIMITS[key] if free else 1e-4
    encoder = sum(p.numel() for _, p in cpu_model.encoder_parameters())
    rec = {
        "phase": phase, "model": cfg.MODEL.MODEL_NAME, "type": cfg.CONTRASTIVE.TYPE,
        "backbone": key, "dtype": str(dtype), "frames": list(batch["frames"].shape),
        "encoder_params": encoder, "params": sum(p.numel() for p in cpu_model.parameters()),
        "launches": launches, "loss": [float(gpu["loss"]), float(cpu["loss"])],
        "grad_norm": [float(gpu["grad_norm"]), float(cpu["grad_norm"])],
        "grad_rel_err": _grad_rel_err(gpu_grads, cpu_grads), "grad_limit": grad_limit,
        "update_rel_err": _update_rel_err({k: got[k] for k in params},
                                          {k: want[k] for k in params}, before),
        "bn_stats_err_over_rtol": _stats_err(
            {k: got[k] for k in want if "running" in k},
            {k: want[k] for k in want if "running" in k})[0],
        "ssl_state_max_abs_err": {name: max((float((got[k] - want[k]).abs().max())
                                              for k in ssl if k.split(".")[0] == name),
                                             default=None)
                                  for name in ("momentum", "queue", "bank")},
        "queue_ptr": [int(got["queue_ptr"]), int(want["queue_ptr"])] if "queue_ptr" in want
        else None,
        "gpu_first_call_s": gpu_s, "cpu_s": cpu_s,
    }
    if free:
        held_model = seeded_model(cfg, "cuda", torch.float32)
        held_model.load_state_dict(before, strict=True)
        with relu_decisions(cpu_decisions) as card_decisions:
            held = gpu_step(init_ssl_state(cfg, held_model), batch, lr, draws)
        rec["relu_decisions_held"] = {
            "grad_rel_err": _grad_rel_err(_grads(held_model), cpu_grads),
            "grad_norm": float(held["grad_norm"]),
            "relu_elements": sum(int(m.numel()) for m in cpu_decisions.masks),
            "card_decisions_otherwise": card_decisions.taken_otherwise,
        }
    log(json.dumps(rec))
    if launches != expected:
        raise AssertionError(f"{phase}: one step launched {launches}, not {expected}")
    torch.testing.assert_close(gpu["loss"], cpu["loss"], atol=0, rtol=1e-4)
    if bool(gpu["nan"]) or bool(cpu["nan"]):
        raise AssertionError(f"{phase}: a loss is not finite")
    if not free:
        torch.testing.assert_close(gpu["grad_norm"], cpu["grad_norm"], atol=0, rtol=1e-4)
    for reading in ("grad_rel_err", "update_rel_err"):
        if rec[reading] > grad_limit:
            raise AssertionError(f"{phase}: {reading} {rec[reading]} over {grad_limit}")
    if free and key not in FLOAT64_HELD:
        held = rec["relu_decisions_held"]
        torch.testing.assert_close(torch.tensor(held["grad_norm"]), cpu["grad_norm"],
                                   atol=0, rtol=1e-4)
        if held["grad_rel_err"] > 1e-4:
            raise AssertionError(f"{phase}: with the CPU's ReLU decisions the gradients "
                                 f"differ by {held['grad_rel_err']}")
    if not (free and key in FLOAT64_HELD) and rec["bn_stats_err_over_rtol"] > 1e-6:
        raise AssertionError(f"{phase}: running statistics over rtol 1e-4")
    over = {k: v for k, v in rec["ssl_state_max_abs_err"].items() if v is not None and v > 1e-4}
    if over or (rec["queue_ptr"] and rec["queue_ptr"][0] != rec["queue_ptr"][1]):
        raise AssertionError(f"{phase}: the SSL state differs: {over}, {rec['queue_ptr']}")
    if free and key in FLOAT64_HELD:
        _ssl_step_card_vs_cpu(phase.replace("_f32_", f"_f64_t{SSL_FLOAT64_FRAMES}_"), cfg,
                              dict(batch, frames=_fewer_frames(batch["frames"],
                                                               SSL_FLOAT64_FRAMES)),
                              expected, torch.float64)
    return rec


def phase_contrastive_card_vs_cpu():
    """3c: each published contrastive yaml at full width, one step at batch
    2 (2 views a video), card against CPU; its encoder's parameter count
    equal to the JAX model's. MoCo in float32 (its gradients held to
    ``RELU_LIMITS["Slow"]``), then, as for every yaml, in float64 on
    ``SSL_FLOAT64_FRAMES`` of the 8 frames under every 1e-4 gate. No conv
    of Slow R50 is on K1: 0 launches."""
    for name in SSL_CFGS:
        cfg = ssl_cfg(name)
        batch = _ssl_batch(cfg, 3)
        if name == "moco":
            dtype, phase = torch.float32, "f32"
        else:
            dtype, phase = torch.float64, f"f64_t{SSL_FLOAT64_FRAMES}"
            batch["frames"] = _fewer_frames(batch["frames"], SSL_FLOAT64_FRAMES)
        rec = _ssl_step_card_vs_cpu(f"contrastive_{name}_step_{phase}_b2_card_vs_cpu",
                                    cfg, batch, step_launches(SLOW_K1), dtype)
        if rec["encoder_params"] != SSL_PARAMS[name]:
            raise AssertionError(f"{name}: {rec['encoder_params']} encoder parameters, the JAX "
                                 f"model has {SSL_PARAMS[name]}")


def phase_contrastive_x3d():
    """3cx: a SimCLR ContrastiveModel on X3D-M's backbone at full width, one
    float32 step at batch 2, card against CPU (the CPU's ReLU decisions
    held, as for X3D-M): two train forwards and their backward, 88 K1 and
    44 wgrad launches. Returns them."""
    cfg = contrastive_x3d_cfg()
    expected = step_launches(2 * X3D_K1)
    rec = _ssl_step_card_vs_cpu("contrastive_x3d_simclr_step_f32_b2_card_vs_cpu", cfg,
                                _ssl_batch(cfg, 4), expected)
    return rec["launches"]


def _ssl_device_batch(cfg, b, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    size = cfg.DATA.TRAIN_CROP_SIZE
    return {"frames": torch.randint(0, 256, (b, 2, cfg.DATA.NUM_FRAMES, size, size, 3),
                                    dtype=torch.uint8, device="cuda", generator=gen),
            "index": torch.arange(b, device="cuda")}


def phase_contrastive_step(card):
    """4c: the MoCo yaml's bf16 step at batch 8 (8 videos, two views each),
    timed alone (2 warm-up steps, then 5 between synchronizes): ms a step,
    clips/s (a clip is one video with its two views), peak memory; 0 K1."""
    from pmv_tpu_torch.engine.ssl_steps import init_ssl_state, make_ssl_train_step

    cfg = ssl_cfg("moco")
    model = seeded_model(cfg, "cuda")  # bfloat16 activations
    state = init_ssl_state(cfg, model)
    step = make_ssl_train_step(cfg, device="cuda", seed=0)
    batch = _ssl_device_batch(cfg, SSL_BATCH, 8)
    lr = cfg.SOLVER.WARMUP_START_LR
    for _ in range(2):
        step(state, batch, lr)
    torch.cuda.synchronize()
    timed = 5
    torch.cuda.reset_peak_memory_stats()
    counts = _launch_counts()
    t0 = time.perf_counter()
    losses = [step(state, batch, lr)["loss"] for _ in range(timed)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed * 1e3
    launches = _launches_since(counts)
    rec = {"phase": "contrastive_moco_step_bf16_b8", "card": card, "batch": SSL_BATCH,
           "views": 2, "steps": timed, "ms_per_step": ms, "clips_per_s": SSL_BATCH / ms * 1e3,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "losses": [float(v) for v in losses]}
    log(json.dumps(rec))
    if launches != {k: 0 for k in launches}:
        raise AssertionError(f"the MoCo steps launched {launches}")
    if not np.all(np.isfinite(rec["losses"])):
        raise AssertionError(f"non-finite MoCo losses {rec['losses']}")


def phase_contrastive_train(card):
    """5c, a main path: 2 steps of ``train_ssl``'s loop body
    (``train_epoch`` over the MoCo step) on batch-8 bf16 synthetic videos of
    two views, after one warm-up step; counts zeroed just before the 2 and
    read just after (0 K1)."""
    from pmv_tpu_torch.engine.ssl_steps import init_ssl_state, make_ssl_train_step
    from pmv_tpu_torch.engine.train import train_epoch
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.utils.meters import TrainMeter

    cfg = ssl_cfg("moco")
    timed = 2
    cfg.LOG_PERIOD = timed
    cfg.SOLVER.MAX_EPOCH = 1
    model = build_model(cfg, device="cuda", seed=0)
    state = init_ssl_state(cfg, model)
    step = make_ssl_train_step(cfg, device="cuda", seed=0)
    metrics = []

    def recording_step(state, batch, lr):
        m = step(state, batch, lr)
        metrics.append(m)
        return m

    rng = np.random.default_rng(9)
    size = cfg.DATA.TRAIN_CROP_SIZE
    loader = [{"frames": rng.integers(0, 256, (SSL_BATCH, 2, cfg.DATA.NUM_FRAMES, size, size, 3),
                                      np.uint8),
               "index": np.arange(SSL_BATCH) + SSL_BATCH * i} for i in range(1 + timed)]
    train_epoch(loader[:1], recording_step, state, TrainMeter(1, cfg), 0, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    train_epoch(loader[1:], recording_step, state, TrainMeter(timed, cfg), 0, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()  # ... and ends here
    losses = [float(m["loss"]) for m in metrics]
    grad_norms = [float(m["grad_norm"]) for m in metrics]
    log(json.dumps({
        "phase": "contrastive_moco_train_epoch_bf16_b8", "card": card, "steps": timed,
        "batch": SSL_BATCH, "wall_s": wall, "ms_per_step": wall / timed * 1e3,
        "clips_per_s": timed * SSL_BATCH / wall,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "losses": losses, "grad_norms": grad_norms,
        "queue_ptr": int(model.queue_ptr), "steps_taken": state.step,
    }))
    if not np.all(np.isfinite(losses + grad_norms)):
        raise AssertionError(f"non-finite losses {losses} or grad norms {grad_norms}")
    if launches != {k: 0 for k in launches} or int(model.queue_ptr) != (1 + timed) * SSL_BATCH:
        raise AssertionError(f"{timed} MoCo steps launched {launches}, queue at "
                             f"{model.queue_ptr}")
    return launches


def moco_pt_argv(out_dir, max_epoch):
    """run_net's arguments for the MoCo yaml: one process, batch 8, the
    Synthetic dataset, the kNN monitor every epoch, a 1-view test (the
    test's views cut from 10 x 3, as the other phases cut them)."""
    return ["--cfg", SSL_CFGS["moco"], "--opts", "NUM_GPUS", "1",
            "TRAIN.BATCH_SIZE", str(SSL_BATCH), "TRAIN.DATASET", "synthetic",
            "TEST.DATASET", "synthetic", "TRAIN.EVAL_PERIOD", "1",
            "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1",
            "SOLVER.MAX_EPOCH", str(max_epoch), "OUTPUT_DIR", out_dir]


def _moco_pt_call(out_dir, max_epoch):
    """One MoCo ``run_net`` call (a main path): its launches, wall time, the
    train and kNN stats and the checkpoint it wrote, from its own log."""
    from pmv_tpu_torch.data.loader import construct_loader
    from pmv_tpu_torch.tools import run_net

    argv = moco_pt_argv(out_dir, max_epoch)
    steps = len(construct_loader(run_net_cfg(argv), "train"))
    log_path = os.path.join(out_dir, "stdout.log")
    skip = 0
    if os.path.exists(log_path):
        with open(log_path) as f:
            skip = len(f.read().splitlines())
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    run_net.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()  # ... and ends here
    with open(log_path) as f:
        lines = f.read().splitlines()[skip:]
    stats = [json.loads(line.split("json_stats: ", 1)[1])
             for line in lines if "json_stats: " in line]
    train_stats = [s for s in stats if s.get("_type") == "train_epoch"][-1]
    knn = [s for s in stats if s.get("_type") == "ssl_knn_epoch"]
    if not np.isfinite(train_stats["loss"]) or not knn or knn[-1]["epoch"] != max_epoch - 1:
        raise AssertionError(f"the MoCo run: train {train_stats}, kNN lines {knn}")
    if launches != {k: 0 for k in launches}:
        raise AssertionError(f"the MoCo run_net launched {launches}")
    saved = _last_match(lines, r"Saved checkpoint to (\S+) in ([\d.]+)s")
    return {
        "phase": f"contrastive_moco_run_net_epoch_{max_epoch}", "wall_s": wall,
        "train_steps": steps, "train_clips": steps * SSL_BATCH,
        "train_clips_per_s_of_wall": steps * SSL_BATCH / wall, "knn": knn[-1],
        "checkpoint": saved[1], "checkpoint_s": float(saved[2]),
        "checkpoint_bytes": os.path.getsize(saved[1]),
        "optimizer_steps": torch.load(saved[1], map_location="cpu", weights_only=True)[
            "optimizer_state"]["param_groups"][0]["count"],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "train_epoch_stats": train_stats,
        "final_stats": stats[-1], "log": lines,
    }


def phase_contrastive_run_net(card, out_dir, ft_dir):
    """6c: ``run_net`` on the MoCo yaml for one epoch (train_ssl, the kNN
    line, its checkpoint); the restore as train_ssl makes it, every tensor
    compared with the file's, the queue, the bank and the momentum encoder
    among them; ``run_net`` again with SOLVER.MAX_EPOCH 2, which must
    resume; then configs/Kinetics/SLOW_8x8_R50.yaml fine-tunes from that
    checkpoint with CLEAR_NAME_PATTERN ["backbone."] (train, precise BN,
    eval, a 1-view test). Main paths; returns their launches."""
    from contextlib import redirect_stdout

    from pmv_tpu_torch.engine.ssl_steps import init_ssl_state
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.utils import checkpoint as cu

    with redirect_stdout(open(os.devnull, "w")):
        first = _moco_pt_call(out_dir, 1)
        cfg = run_net_cfg(moco_pt_argv(out_dir, 2))
        state = init_ssl_state(cfg, build_model(cfg, device="cuda", seed=cfg.RNG_SEED))
        last = cu.get_last_checkpoint(cfg.OUTPUT_DIR, cfg.TASK)
        start = cu.load_checkpoint(last, state) + 1
        ckpt = torch.load(last, map_location="cpu", weights_only=True)
        restored = {"checkpoint": last, **_compare_restored(state, ckpt, start),
                    "ssl_tensors": sorted({k.split(".")[0] for k in ckpt["model_state"]}
                                          & {"momentum", "queue", "queue_ptr", "bank"})}
        del state
        second = _moco_pt_call(out_dir, 2)
        ft = _run_net_call("slow_ft", ft_dir, 1, ["TRAIN.CHECKPOINT_FILE_PATH",
                                                   second["checkpoint"]])
    if restored["start_epoch"] != 1 or restored["checkpoint"] != first["checkpoint"] or \
            restored["ssl_tensors"] != ["bank", "momentum", "queue", "queue_ptr"]:
        raise AssertionError(f"the MoCo restore: {restored}")
    if not (any(f"Resumed SSL training from {first['checkpoint']}" in line
                for line in second["log"])
            and any("Start epoch: 2" in line for line in second["log"])):
        raise AssertionError("the second MoCo call did not resume from the first's checkpoint")
    if second["optimizer_steps"] != first["optimizer_steps"] + second["train_steps"]:
        raise AssertionError(f"the MoCo optimizer took {second['optimizer_steps']} steps")
    # The first load is the MoCo checkpoint's (test() loads the FT run's own).
    loaded = next(m for m in map(re.compile(
        r"Loaded (\d+) of the model's (\d+) tensors from the checkpoint; (\d+) kept "
        r"their init").search, ft["log"]) if m)
    ft["tensors_loaded"], ft["tensors"], ft["tensors_kept_init"] = map(int, loaded.groups())
    if ft["tensors_kept_init"] != 2:  # the head's projection: weight and bias
        raise AssertionError(f"the Slow fine-tuning kept {ft['tensors_kept_init']} at init")
    for rec in (first, second, ft):
        rec.pop("log")
        log(json.dumps({**rec, "card": card}))
    log(json.dumps({"phase": "contrastive_moco_run_net_restore", **restored}))
    return [first["launches"], second["launches"], ft["launches"]]


def _ssl_dist_rank(rank, world, port, work_dir, result_q):
    """Phase 8d's rank: join the gloo job on the one card, then each SSL
    case's ``dp`` step on this rank's rows of the global batch with the
    global batch's draws. Puts its error, or None, on ``result_q``."""
    import datetime
    import traceback

    try:
        from pmv_tpu_torch.engine import ssl_steps
        from pmv_tpu_torch.models import build_model
        from pmv_tpu_torch.parallel import distributed
        from pmv_tpu_torch.tools.grad_witness import Decisions, max_pool_decisions

        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
        float32_without_tf32()
        device = torch.device("cuda", 0)
        distributed.init_distributed(rank, world, f"tcp://127.0.0.1:{port}", device, "gloo",
                                     timeout=datetime.timedelta(seconds=120))
        results = {}
        for name, case in torch.load(os.path.join(work_dir, "ssl_cases.pt"),
                                     weights_only=False).items():
            cfg = case["cfg"]
            model = build_model(cfg, device=device, dtype=case["dtype"], seed=0)
            model.load_state_dict(case["state_dict"])
            state = ssl_steps.init_ssl_state(
                cfg, model, wrapped=distributed.wrap_model(model, "dp", device))
            make = (ssl_steps.make_masked_train_step if name == "maskfeat"
                    else ssl_steps.make_ssl_train_step)
            b = len(case["batch"]["frames"]) // world
            local = {k: v[rank * b:(rank + 1) * b] for k, v in case["batch"].items()}
            taps = None
            if case.get("taps") is not None:  # this rank's rows of the one process's
                taps = Decisions([m[rank * b:(rank + 1) * b] for m in case["taps"]])
            counts = _launch_counts()
            with max_pool_decisions(taps) if taps else contextlib.nullcontext():
                metrics = {k: v.cpu() for k, v in make(cfg, device=device, seed=0)(
                    state, local, cfg.SOLVER.BASE_LR, case["draws"]).items()}
            torch.cuda.synchronize()
            results[name] = {
                "metrics": metrics, "launches": _launches_since(counts),
                "grads": {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()},
                "state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            }
            del state, model
            torch.cuda.empty_cache()
        torch.save(results, os.path.join(work_dir, f"ssl_rank{rank}.pt"))
        distributed.destroy()
        result_q.put((rank, None))
    except BaseException:  # reported to the parent, which raises
        result_q.put((rank, traceback.format_exc()))
        raise


def _ssl_dist_cases():
    """Phase 8d's cases at full width, each with its one-process step on the
    global batch of 4, on the card: the MoCo and SimCLR steps (2 videos of 2
    views a rank) in float64 activations (Slow R50's ReLUs decide with
    float32's rounding); the MaskFeat step with loader masks of unequal
    counts on the two ranks in float32 (K1 takes no float64), its skip max
    pools taking the one-process step's taps on every rank (``taps``)."""
    from pmv_tpu_torch.engine import ssl_steps
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.tools.grad_witness import max_pool_decisions

    cases, refs = {}, {}
    for name in ("moco", "simclr", "maskfeat"):
        dtype, taps = torch.float64, contextlib.nullcontext()
        if name == "maskfeat":
            cfg = maskfeat_cfg()
            rng = np.random.default_rng(6)
            clip = _maskfeat_clip(cfg)
            dtype, taps = torch.float32, max_pool_decisions()
            model = build_model(cfg, device="cuda", dtype=dtype, seed=0)
            n_tok = model.sample_mask((1, *clip), torch.Generator()).shape[1]
            batch = {"frames": rng.integers(0, 256, (2 * DIST_BATCH, *clip), np.uint8),
                     "mask": rng.uniform(size=(2 * DIST_BATCH, n_tok))
                     < np.array([0.6, 0.5, 0.1, 0.2])[:, None]}
            step = ssl_steps.make_masked_train_step(cfg, device="cuda", seed=0)
            draws = step.sample_draws(model, batch["frames"].shape)
            draws["mask"] = None
        else:
            cfg = ssl_cfg(name)
            batch = _ssl_batch(cfg, 7, b=2 * DIST_BATCH)
            _, model = _ssl_models_card_and_cpu(cfg, torch.float64)
            step = ssl_steps.make_ssl_train_step(cfg, device="cuda", seed=0)
            draws = step.sample_draws(batch["frames"].shape[:1] + batch["frames"].shape[2:])
        state_dict = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        with taps as record:
            metrics = {k: v.cpu() for k, v in step(ssl_steps.init_ssl_state(cfg, model), batch,
                                                  cfg.SOLVER.BASE_LR, draws).items()}
        cases[name] = {"cfg": cfg, "state_dict": state_dict, "batch": batch, "draws": draws,
                       "dtype": dtype, "taps": [m.cpu() for m in record.masks] if record else None}
        refs[name] = (metrics, _grads(model),
                      {k: v.detach().cpu() for k, v in model.state_dict().items()},
                      sum(p.numel() for p in model.parameters()))
        del model
        torch.cuda.empty_cache()
    return cases, refs


def phase_distributed_ssl():
    """Phase 8d: two ranks over gloo sharing the one card, the SSL steps
    under ``dp`` (``_ssl_dist_cases``), each rank's against the one-process
    step on the global batch under phase 3b's gates (``_held_to_step``), the
    grad norm to 1e-4 and the SSL state (momentum encoder, queue, bank) to
    1e-5 besides. Returns the ranks' launches (0: Slow R50 has no K1 conv;
    MaskFeat's 14 a forward)."""
    import multiprocessing

    work_dir = os.path.join("build", "chip_smoke_distributed_ssl")
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    cases, refs = _ssl_dist_cases()
    torch.save(cases, os.path.join(work_dir, "ssl_cases.pt"))
    world = 2
    ctx = multiprocessing.get_context("spawn")
    result_q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_ssl_dist_rank, args=(r, world, port, work_dir, result_q))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        errors = [result_q.get(timeout=300) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    failed = [e for _, e in errors if e]
    if failed:
        raise AssertionError("a phase 8d rank failed:\n" + "\n".join(failed))
    ranks = [torch.load(os.path.join(work_dir, f"ssl_rank{r}.pt"), weights_only=False)
             for r in range(world)]
    launches = {k: 0 for k in _launch_counts()}
    for name, (metrics, grads, state, n_params) in refs.items():
        expected = step_launches(MASKFEAT_K1 if name == "maskfeat" else SLOW_K1)
        for rank, r in enumerate(ranks):
            got = r[name]
            ssl = [k for k in state if k.split(".")[0] in ("momentum", "queue", "bank")]
            ssl_err = max((float((got["state"][k] - state[k]).abs().max()) for k in ssl),
                          default=0.0)
            dtype = "f32" if name == "maskfeat" else "f64"
            rec = _held_to_step(f"distributed_gloo_{name}_dp_{dtype}_rank{rank}_vs_one_process",
                                (got["metrics"], got["grads"], got["state"]),
                                (metrics, grads, state), cases[name]["cfg"].SOLVER.BASE_LR,
                                n_params, world=world, rows_per_rank=DIST_BATCH,
                                step_launches=got["launches"], ssl_state_max_abs_err=ssl_err,
                                spawn_to_end_s=wall)
            torch.testing.assert_close(got["metrics"]["grad_norm"], metrics["grad_norm"],
                                       atol=0, rtol=1e-4)
            if ssl_err > 1e-5 or got["launches"] != expected:
                raise AssertionError(f"{rec['phase']}: SSL state {ssl_err}, launches "
                                     f"{got['launches']}, not {expected}")
            launches = {k: v + got["launches"][k] for k, v in launches.items()}
    return launches


# Multigrid training of SlowFast 8x8 R50
# (configs/Kinetics/SLOWFAST_8x8_R50_stepwise_multigrid.yaml), phases 3g, 4g,
# 6g with 6p, and 6b.

MULTIGRID_CFG = os.path.join(ROOT, "configs", "Kinetics",
                             "SLOWFAST_8x8_R50_stepwise_multigrid.yaml")
# What a Synthetic epoch of 32 or 64 videos needs of the recipe: its schedule then
# visits every BatchNorm type of the full recipe in 6 epochs (16 x 8 x 158
# sub 8, 8 x 16 x 158 sub 4, 4 x 16 x 224 sub 2, 2 x 32 x 224 plain).
MULTIGRID_RUN = ["TRAIN.BATCH_SIZE", "2", "MULTIGRID.BN_BASE_SIZE", "2",
                 "SOLVER.MAX_EPOCH", "4", "SOLVER.STEPS", "[0, 3]"]
MULTIGRID_RESUME = 4  # 6g: checkpoint 4 (after epoch 3, 4 splits) resumes at epoch 4
SHAPE_STEPS = 2  # 4g's timed steps at each short-cycle batch, after one warm-up


def multigrid_cfg(*opts):
    """The multigrid recipe in one process (the yaml says 8)."""
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(MULTIGRID_CFG)
    cfg.merge_from_list(["NUM_GPUS", "1", *opts])
    return cfg


def norm_of(cfg):
    from pmv_tpu_torch.models.batchnorm import norm_name

    return norm_name(cfg)


def phase_sub_batchnorm_card_vs_cpu():
    """3g: SlowFast 8x8 R50 with SubBatchNorms of 2 splits, one float32 SGD
    step at batch 4 (2 clips a split), card against CPU under phase 3s's
    gates (the float32 gradients to ``RELU_LIMITS``, the step again in
    float64 under every 1e-4 gate), the split running statistics to rtol
    1e-4, atol 1e-6; then each model's norms swapped to plain BatchNorm and
    back (``swap_norms``): the card's converted statistics equal to the same
    conversion, on the CPU, of the card's own, and card against CPU under
    the statistics' gate. 0 K1 launches. (The float64 step takes every
    other frame, as every float64 rerun of ``_train_step_card_vs_cpu``.)"""
    from pmv_tpu_torch.models.batchnorm import swap_norms

    cfg = slowfast_cfg()
    cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS = "sub_batchnorm", 2
    plain = cfg.clone()
    plain.BN.NORM_TYPE = "batchnorm"
    rng = np.random.default_rng(2)
    batch = {"frames": rng.integers(0, 256, (4, cfg.DATA.NUM_FRAMES, 224, 224, 3), np.uint8),
             "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, 4)}
    cpu_model, gpu_model = _models_card_and_cpu(cfg)
    _train_step_card_vs_cpu("slowfast_sub_bn_train_step_f32_b4_card_vs_cpu", cfg, batch,
                            step_launches(SLOWFAST_K1), models=(cpu_model, gpu_model))
    for name, to_cfg in (("sub_to_plain", plain), ("plain_to_sub", cfg)):
        shadow = copy.deepcopy(cpu_model)  # the card's statistics, converted on the CPU
        shadow.load_state_dict({**shadow.state_dict(), **_running_stats(gpu_model)})
        turned = [swap_norms(m, to_cfg) for m in (gpu_model, cpu_model, shadow)]
        conversion_err = _stats_err(_running_stats(gpu_model), _running_stats(shadow))[1]
        over, diff = _running_stats_err(gpu_model, cpu_model)
        rec = {"phase": f"slowfast_sub_bn_swap_{name}", "norms_turned": turned,
               "card_vs_cpu_conversion_max_abs_err": conversion_err,
               "bn_stats_err_over_rtol": over, "bn_stats_max_abs_err": diff,
               "s5_slow_a_bn_stats": list(gpu_model.get_submodule(
                   "s5.pathway0_res0.branch2.a_bn").running_mean.shape)}
        log(json.dumps(rec))
        if len(set(turned)) != 1 or not turned[0]:
            raise AssertionError(f"3g: the swaps turned {turned} norms")
        if conversion_err != 0.0 or over > 1e-6:
            raise AssertionError(f"3g: {name}: conversion {conversion_err}, statistics {over}")


def phase_multigrid_shapes(card):
    """4g: the bf16 train step at each long-cycle shape of the full recipe
    at TRAIN.BATCH_SIZE 8 (64 x 8 x 158 sub 8, 32 x 16 x 158 sub 4,
    16 x 16 x 224 sub 2, 8 x 32 x 224 plain), each at its short cycle's
    three batches: one warm-up and SHAPE_STEPS timed steps of each, one
    model whose norms turn as the schedule does (a main path). Returns its
    launches."""
    from pmv_tpu_torch.data.loader import short_cycle_factors
    from pmv_tpu_torch.engine.steps import init_state, make_train_step
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.models.batchnorm import swap_norms
    from pmv_tpu_torch.utils.multigrid import MultigridSchedule

    cfg = multigrid_cfg("TRAIN.BATCH_SIZE", "8")
    mg = MultigridSchedule()
    mg.init_multigrid(cfg)
    model = build_model(cfg, device="cuda", seed=0)
    state = init_state(cfg, model)
    step = make_train_step(cfg, device="cuda", seed=0)
    gen = torch.Generator("cuda").manual_seed(0)
    seen = set()
    _zero_launch_counts()  # the main path starts here
    for epoch in range(cfg.SOLVER.MAX_EPOCH):  # each step of the schedule repeats the cycles
        mg.update_long_cycle(cfg, epoch)
        shape = (cfg.TRAIN.BATCH_SIZE, cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE)
        if shape in seen:
            continue
        seen.add(shape)
        swap_norms(model, cfg)
        f0, f1 = short_cycle_factors(cfg)
        crops = [int(round(f * cfg.MULTIGRID.DEFAULT_S)) for f in cfg.MULTIGRID.SHORT_CYCLE_FACTORS]
        b, t = cfg.TRAIN.BATCH_SIZE, cfg.DATA.NUM_FRAMES
        phases = []
        for clips, crop in ((b * f0, crops[0]), (b * f1, crops[1]), (b, cfg.DATA.TRAIN_CROP_SIZE)):
            batch = {"frames": torch.randint(0, 256, (clips, t, crop, crop, 3), generator=gen,
                                             device="cuda", dtype=torch.uint8),
                     "labels": torch.randint(0, cfg.MODEL.NUM_CLASSES, (clips,), generator=gen,
                                             device="cuda")}
            torch.cuda.reset_peak_memory_stats()
            m = step(state, batch, X3D_LR)  # warm-up: cuDNN picks its algorithms
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SHAPE_STEPS):
                m = step(state, batch, X3D_LR)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / SHAPE_STEPS * 1e3
            if not bool(torch.isfinite(m["loss"])):
                raise AssertionError(f"4g: a non-finite loss at {clips} x {t} x {crop}^2")
            phases.append({"clips": clips, "frames": t, "crop": crop, "ms": ms,
                           "clips_per_s": clips / ms * 1e3,
                           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
        log(json.dumps({"phase": "multigrid_shape_bf16", "card": card, "epoch": epoch,
                        "long_cycle": [b, t, cfg.DATA.TRAIN_CROP_SIZE], "bn": norm_of(cfg),
                        "short_cycle": phases}))
    launches = _launch_counts()  # ... and ends here
    if len(seen) != 4 or launches != step_launches(SLOWFAST_K1):
        raise AssertionError(f"4g: {len(seen)} shapes, {launches} launched")
    return launches


def multigrid_argv(out_dir, profile_dir=None):
    """run_net's arguments for the schedule on Synthetic, a 2-view
    test of 8 clips a batch; with TPU.PROFILE_DIR when ``profile_dir``."""
    argv = ["--cfg", MULTIGRID_CFG, "--opts", *MULTIGRID_RUN, "NUM_GPUS", "1",
            "TRAIN.DATASET", "synthetic", "TEST.DATASET", "synthetic",
            "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "1",
            "TEST.BATCH_SIZE", "8", "OUTPUT_DIR", out_dir]
    return argv + (["TPU.PROFILE_DIR", profile_dir] if profile_dir else [])


def _multigrid_call(argv):
    """One ``run_net`` call on the schedule (a main path); its launches,
    wall seconds, epochs' lines and stats."""
    from pmv_tpu_torch.tools import run_net

    out_dir = argv[argv.index("OUTPUT_DIR") + 1]
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    run_net.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()  # ... and ends here
    with open(os.path.join(out_dir, "stdout.log")) as f:
        lines = f.read().splitlines()
    epochs = [m.groups() for m in map(re.compile(
        r"Epoch (\d+): (\d+) clips a step \((\d+) steps\), (\d+) frames, crop (\d+), (.+)").search,
        lines) if m]
    times = {int(m[1]): float(m[2]) for m in map(
        re.compile(r"Epoch (\d+) takes ([\d.]+)s").search, lines) if m}
    stats = [json.loads(line.split("json_stats: ", 1)[1]) for line in lines
             if "json_stats: " in line]
    if stats[-1].get("split") != "test_final":
        raise AssertionError(f"6g: run_net ended without test_final: {stats[-1]}")
    if launches != {"depthwise3x3x3": 0, "depthwise3x3x3_wgrad": 0}:
        raise AssertionError(f"6g: run_net launched {launches}")
    return {"wall_s": wall, "launches": launches, "lines": lines, "stats": stats,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "epochs": [{"epoch": int(e), "clips_a_step": int(b), "steps": int(n),
                        "frames": int(t), "crop": int(s), "bn": bn, "epoch_s": times[int(e)]}
                       for e, b, n, t, s, bn in epochs]}


def _expected_epochs(argv):
    """(epoch, clips a step, frames, crop, BN) of each epoch of the schedule
    that run_net builds from ``argv``, and its evaluated epochs."""
    from pmv_tpu_torch.utils import misc
    from pmv_tpu_torch.utils.multigrid import MultigridSchedule

    cfg = run_net_cfg(argv)
    mg = MultigridSchedule()
    mg.init_multigrid(cfg)
    want, evals = [], []
    for epoch in range(cfg.SOLVER.MAX_EPOCH):
        mg.update_long_cycle(cfg, epoch)
        want.append((epoch, cfg.TRAIN.BATCH_SIZE, cfg.DATA.NUM_FRAMES,
                     cfg.DATA.TRAIN_CROP_SIZE, norm_of(cfg)))
        evals.append(misc.is_eval_epoch(cfg, epoch, mg.schedule))
    return want, evals


def check_multigrid_restore(argv, path):
    """Restore checkpoint ``path`` as ``train()`` does under multigrid: the
    model built at the cfg's base BatchNorm type, its norms turned to the
    long cycle of the checkpoint's epoch once the file is read, then the
    load; every tensor must equal the file's."""
    from pmv_tpu_torch.engine.steps import init_state
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.models.batchnorm import swap_norms
    from pmv_tpu_torch.utils import checkpoint as cu
    from pmv_tpu_torch.utils.multigrid import MultigridSchedule

    cfg = run_net_cfg(argv)
    mg = MultigridSchedule()
    mg.init_multigrid(cfg)
    model = build_model(cfg, device="cuda", seed=cfg.RNG_SEED)
    state = init_state(cfg, model)

    def at(epoch):
        mg.update_long_cycle(cfg, epoch)
        swap_norms(model, cfg)

    epoch = cu.load_checkpoint(path, state, before_load=at)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {"checkpoint": path, "bn": norm_of(cfg), **_compare_restored(state, ckpt, epoch + 1)}


def phase_multigrid_run_net(card, out_dir, resume_dir, profile_dir):
    """6g: ``run_net`` on the schedule over ``MULTIGRID_VIDEOS`` Synthetic
    videos (one process, bf16, precise BN after every epoch, the evaluations of
    ``is_eval_epoch``, a 2-view test), with the profiler window (6p) on:
    each epoch's batch, frames, crop and BatchNorm type as the schedule
    gives them, the precise-BN line each epoch, test_final; the restore of
    checkpoint ``MULTIGRID_RESUME`` (a sub_batchnorm epoch), every tensor
    compared; then that checkpoint alone in a fresh OUTPUT_DIR, from which
    run_net must resume at its next epoch, in that epoch's shape and
    BatchNorm type, and finish (main paths). Returns their launches."""
    from contextlib import redirect_stdout

    argv = multigrid_argv(out_dir, profile_dir)
    want, evals = _expected_epochs(argv)
    with redirect_stdout(open(os.devnull, "w")):
        first = _multigrid_call(argv)
        ckpt = os.path.join(out_dir, "checkpoints",
                            f"checkpoint_epoch_{MULTIGRID_RESUME:05d}.pyth")
        restored = check_multigrid_restore(argv, ckpt)
        os.makedirs(os.path.join(resume_dir, "checkpoints"))
        shutil.copy(ckpt, os.path.join(resume_dir, "checkpoints"))
        second = _multigrid_call(multigrid_argv(resume_dir))
    got = [(e["epoch"], e["clips_a_step"], e["frames"], e["crop"], e["bn"])
           for e in first["epochs"]]
    if got != want:
        raise AssertionError(f"6g: the epochs ran {got}, the schedule says {want}")
    lines = first["lines"]
    precise = sum("Updated precise BN stats over" in line for line in lines)
    val_epochs = [s["epoch"] for s in first["stats"] if s.get("_type") == "val_epoch"]
    if precise != len(want) or len(val_epochs) != sum(evals):
        raise AssertionError(f"6g: {precise} precise-BN lines, evaluations {val_epochs}")
    if restored["start_epoch"] != MULTIGRID_RESUME or "sub_batchnorm" not in restored["bn"]:
        raise AssertionError(f"6g: the restore {restored}")
    got2 = [(e["epoch"], e["clips_a_step"], e["frames"], e["crop"], e["bn"])
            for e in second["epochs"]]
    if (got2 != want[MULTIGRID_RESUME:]
            or not any(f"Start epoch: {MULTIGRID_RESUME + 1}" in x for x in second["lines"])):
        raise AssertionError(f"6g: the resumed run ran {got2}")
    for name, rec in (("multigrid_run_net", first), ("multigrid_run_net_resumed", second)):
        log(json.dumps({"phase": name, "card": card, "wall_s": rec["wall_s"],
                        "epochs": rec["epochs"], "launches": rec["launches"],
                        "max_memory_allocated_bytes": rec["max_memory_allocated_bytes"],
                        "evaluated_epochs": val_epochs if rec is first else None,
                        "precise_bn_lines": precise if rec is first else None,
                        "final_stats": rec["stats"][-1]}))
    log(json.dumps({"phase": "multigrid_run_net_restore", **restored}))
    phase_profiler_window(first["lines"], profile_dir)
    return [first["launches"], second["launches"]]


def phase_profiler_window(lines, profile_dir):
    """6p: the trace that 6g's first call wrote with TPU.PROFILE_DIR: one
    file, its bytes, the steps its log line names, and its CUDA kernel
    events (there must be some)."""
    traces = sorted(os.listdir(profile_dir))
    if len(traces) != 1:
        raise AssertionError(f"6p: {len(traces)} traces in {profile_dir}")
    path = os.path.join(profile_dir, traces[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    window = _last_match(lines, r"Profiled steps (\d+) to (\d+) of epoch 0")
    rec = {"phase": "profiler_window", "trace": path, "bytes": os.path.getsize(path),
           "steps": [int(window[1]), int(window[2])], "events": len(events),
           "cuda_kernel_events": len(kernels),
           "cuda_kernel_ms": sum(e.get("dur", 0) for e in kernels) / 1e3}
    log(json.dumps(rec))
    if not kernels:
        raise AssertionError("6p: the trace holds no CUDA kernel event")


def phase_data_benchmark(out_dir):
    """6b: ``python -m pmv_tpu_torch.tools.benchmark`` (a process of its
    own, so that its peak RAM is the loader's) on SlowFast 8x8 R50's yaml,
    Synthetic, batch 8, one epoch: the loader's clips/s and the process's
    peak RAM. Synthetic draws its clips with numpy: this measures the
    loader's threads and collate on the card's host, not decoding (no
    FFmpeg there)."""
    import subprocess

    argv = [sys.executable, "-m", "pmv_tpu_torch.tools.benchmark", "--cfg", SLOWFAST_CFG,
            "--opts", "NUM_GPUS", "1", "TRAIN.DATASET", "synthetic", "TRAIN.BATCH_SIZE", "8",
            "BENCHMARK.NUM_EPOCHS", "1", "BENCHMARK.LOG_PERIOD", "4", "OUTPUT_DIR", out_dir]
    t0 = time.perf_counter()
    subprocess.run(argv, cwd=ROOT, check=True, timeout=300, stdout=subprocess.DEVNULL)
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, "stdout.log")) as f:
        lines = f.read().splitlines()
    done = _last_match(lines, r"Benchmark complete: (\d+) clips loaded, ([\d.]+) s/batch, "
                              r"([\d.]+) clips/s, RAM ([\d.]+) GB")
    rec = {"phase": "data_loading_benchmark", "what": "Synthetic: numpy draws, the loader's "
           "threads and collate on the host; no decoding", "wall_s": wall,
           "clips": int(done[1]), "s_per_batch": float(done[2]),
           "clips_per_s": float(done[3]), "ram_gb": float(done[4])}
    log(json.dumps(rec))
    if rec["clips"] != 64:
        raise AssertionError(f"6b: the benchmark loaded {rec['clips']} clips, not 64")


def imports(module):
    """True when ``module`` imports, else why not (printed, not a gate:
    ``torch.utils.tensorboard`` is needed only with TENSORBOARD.ENABLE,
    matplotlib by ``plot_eval`` and Grad-CAM's ``overlay_heatmap``, cv2 by
    the demo's webcam, moviepy by the writer's videos)."""
    import importlib

    try:
        importlib.import_module(module)
    except ImportError as e:
        return str(e)
    return True


DIST_BATCH = 2  # rows a rank in phase 8a
DIST_TIMED_STEPS = 5  # phase 8b's timed steps of each wrapper
DIST_TIMED_STEPS_GLOO = 2  # phase 8a's timed steps, each rank


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dist_rank(rank, world, port, work_dir, result_q):
    """Phase 8a's rank: join the gloo job on the one card, report which
    collectives gloo carries on CUDA tensors (rank 0), then one float32
    ``dp`` train step of UniFormer-S on this rank's rows of the global batch
    (the compared one, its K1 and wgrad launches counted), then
    ``DIST_TIMED_STEPS_GLOO`` more steps, timed (a main path: launch counts
    zeroed just before them, read just after). Puts its results, or its
    error, on ``result_q``."""
    import datetime
    import traceback

    import torch.distributed as dist

    try:
        from pmv_tpu_torch.engine.steps import init_state, make_train_step
        from pmv_tpu_torch.models import build_model
        from pmv_tpu_torch.parallel import distributed

        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))  # the host's cores
        float32_without_tf32()  # as the one-process step in the parent
        device = torch.device("cuda", 0)
        distributed.init_distributed(rank, world, f"tcp://127.0.0.1:{port}", device, "gloo",
                                     timeout=datetime.timedelta(seconds=120))
        carried = {}
        for name, op in (
            ("all_reduce", lambda t: dist.all_reduce(t)),
            ("broadcast", lambda t: dist.broadcast(t, 0)),
            ("all_gather", lambda t: dist.all_gather([torch.empty_like(t) for _ in range(world)], t)),
        ):
            try:
                op(torch.ones(4, device=device))
                torch.cuda.synchronize()
                carried[name] = True
            except (RuntimeError, ValueError) as e:  # the same on both ranks
                carried[name] = str(e).splitlines()[0]
        case = torch.load(os.path.join(work_dir, "case.pt"), weights_only=False)
        cfg = case["cfg"]
        model = build_model(cfg, device=device, dtype=torch.float32, seed=0)
        model.load_state_dict(case["state_dict"])
        wrapped = distributed.wrap_model(model, "dp", device)
        state = init_state(cfg, model, wrapped=wrapped)
        step = make_train_step(cfg, device=device, seed=0)
        local = {k: v[rank * DIST_BATCH:(rank + 1) * DIST_BATCH]
                 for k, v in case["batch"].items()}
        counts = _launch_counts()
        metrics = {k: v.cpu() for k, v in step(state, local, cfg.SOLVER.BASE_LR).items()}
        torch.cuda.synchronize()
        result = {
            "rank": rank, "carried": carried, "metrics": metrics,
            "step_launches": _launches_since(counts),
            # Copies: the timed steps below move the model's tensors in place.
            "grads": {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()},
            "state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
        }
        _zero_launch_counts()  # the main path starts here
        t0 = time.perf_counter()
        for _ in range(DIST_TIMED_STEPS_GLOO):
            step(state, local, cfg.SOLVER.BASE_LR)
        torch.cuda.synchronize()
        result["ms_per_step"] = (time.perf_counter() - t0) / DIST_TIMED_STEPS_GLOO * 1e3
        result["launches"] = _launch_counts()  # ... and ends here
        torch.save(result, os.path.join(work_dir, f"rank{rank}.pt"))
        distributed.destroy()
        result_q.put((rank, None))
    except BaseException:  # reported to the parent, which raises
        result_q.put((rank, traceback.format_exc()))
        raise


def _step_readings(phase, got, ref, **extra):
    """``got`` (a train step's metrics, gradients, state after it) against
    ``ref``'s: the readings phase 3b's gates hold; logged."""
    (gm, gg, gs), (rm, rg, rs) = got, ref
    grad_rel = _grad_rel_err(gg, rg)
    stats = [k for k in rs if "running" in k]
    stats_over = max((float(((gs[k] - rs[k]).abs() - 1e-4 * rs[k].abs()).max()) for k in stats),
                     default=0.0)
    weights = [k for k in rg]
    param_err = max(float((gs[k] - rs[k]).abs().max()) for k in weights)
    n_off = sum(int(((gs[k] - rs[k]).abs() > 1e-6).sum()) for k in weights)
    rec = {"phase": phase, "loss": [float(gm["loss"]), float(rm["loss"])],
           "grad_norm": [float(gm["grad_norm"]), float(rm["grad_norm"])],
           "grad_rel_err": grad_rel, "bn_stats": len(stats), "bn_stats_err_over_rtol": stats_over,
           "param_max_abs_err": param_err, "params_off_by_1e-6": n_off, **extra}
    log(json.dumps(rec))
    return rec


def _held_to_step(phase, got, ref, lr, n_params, **extra):
    """Phase 3b's gates, ``got`` (metrics, gradients, state) against
    ``ref``'s: loss rtol 1e-4, gradients 1e-4 (relative L2), BatchNorm
    running statistics rtol 1e-4 (atol 1e-6), the weights within 2 x lr
    after AdamW (a few of them: their gradient is float noise). Logs the
    readings, with ``extra``, before it holds them."""
    rec = _step_readings(phase, got, ref, **extra)
    grad_rel, stats_over = rec["grad_rel_err"], rec["bn_stats_err_over_rtol"]
    param_err, n_off = rec["param_max_abs_err"], rec["params_off_by_1e-6"]
    torch.testing.assert_close(got[0]["loss"], ref[0]["loss"], atol=0, rtol=1e-4)
    if grad_rel > 1e-4:
        raise AssertionError(f"{phase}: gradients differ by {grad_rel} (relative L2)")
    if stats_over > 1e-6:
        raise AssertionError(f"{phase}: running statistics {stats_over} over rtol 1e-4")
    if param_err > 2.0001 * lr or n_off > 1e-4 * n_params:
        raise AssertionError(f"{phase}: weights differ by {param_err}, {n_off} by > 1e-6")
    return rec


def phase_distributed_gloo():
    """Phase 8a: two ranks over gloo sharing the one card. UniFormer-S 16x4
    at full width (BatchNorm, K1 on its 18 DPE convs a forward), float32,
    the PMV rect crop with SWITCH_AUTO, MixUp on, 2 rows a rank, one portrait
    row on rank 0 and none on rank 1; each rank's ``dp`` step against the
    one-process step on the global batch of 4 under phase 3b's gates. The
    kernels were built in phase 1: the ranks only load them. Returns the
    ranks' launches."""
    import multiprocessing

    from pmv_tpu_torch.engine.steps import init_state, make_train_step
    from pmv_tpu_torch.models import build_model

    cfg = uniformer_cfg()
    cfg.TRAIN.MIXED_PRECISION = False
    cfg.MIXUP.ENABLE = True
    cfg.DATA.TRAIN_CROP_SIZE_RECT = list(PMV_RECT)
    cfg.DATA.TRAIN_CROP_SIZE_RECT_SWITCH_AUTO = True
    world, n = 2, 2 * DIST_BATCH
    rng = np.random.default_rng(8)
    batch = {
        "frames": rng.integers(0, 256, (n, cfg.DATA.NUM_FRAMES, *PMV_RECT, 3), np.uint8),
        "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, n),
        "pm": np.array([True, False, False, False]),
    }
    work_dir = os.path.join("build", "chip_smoke_distributed")
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    model = build_model(cfg, device="cuda", dtype=torch.float32, seed=0)
    state_dict = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.save({"cfg": cfg, "state_dict": state_dict, "batch": batch},
               os.path.join(work_dir, "case.pt"))
    state = init_state(cfg, model)
    t0 = time.perf_counter()
    metrics = {k: v.cpu() for k, v in make_train_step(cfg, device="cuda", seed=0)(
        state, batch, cfg.SOLVER.BASE_LR).items()}
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    ref = (metrics, _grads(model), {k: v.detach().cpu() for k, v in model.state_dict().items()})
    n_params = sum(p.numel() for p in model.parameters())
    del state, model
    torch.cuda.empty_cache()

    ctx = multiprocessing.get_context("spawn")
    result_q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_dist_rank, args=(r, world, port, work_dir, result_q))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        errors = [result_q.get(timeout=240) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    failed = [e for _, e in errors if e]
    if failed:
        raise AssertionError("a phase 8a rank failed:\n" + "\n".join(failed))
    ranks = [torch.load(os.path.join(work_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    log(json.dumps({"phase": "distributed_gloo_collectives_on_cuda",
                    "carried": ranks[0]["carried"]}))
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    expected = step_launches(2 * UNIFORMER_K1)  # the select: both orientations
    for r in ranks:
        _held_to_step(f"distributed_gloo_dp_rank{r['rank']}_vs_one_process",
                      (r["metrics"], r["grads"], r["state"]), ref, cfg.SOLVER.BASE_LR, n_params,
                      model=cfg.MODEL.MODEL_NAME, world=world, rows_per_rank=DIST_BATCH,
                      step_launches=r["step_launches"], launches=r["launches"],
                      timed_steps=DIST_TIMED_STEPS_GLOO, ms_per_step_2_ranks=r["ms_per_step"],
                      one_process_first_step_s=one_s, spawn_to_end_s=wall)
        if r["step_launches"] != expected:
            raise AssertionError(
                f"rank {r['rank']}'s step launched {r['step_launches']}, not {expected}")
        timed = {k: v * DIST_TIMED_STEPS_GLOO for k, v in expected.items()}
        if r["launches"] != timed:
            raise AssertionError(f"rank {r['rank']}'s timed steps launched {r['launches']}, "
                                 f"not {timed}")
    return launches


DIST_RUN_NET_TIMEOUT_S = 300  # phase 8c: one run_net call, its processes together


def _write_counts(path):
    with open(path, "w") as f:
        json.dump(_launch_counts(), f)


def _counted_run_process(local_rank, cfg, init_method, func, device_type):
    """A process that ``launch_job`` spawned: ``distributed._run_process``
    (join the group, run ``func``, leave), float32 in float32, then its
    kernel launches to ``$PMV_SMOKE_COUNTS.rank<rank>.json`` and the
    distinct (call, shape) of its K1 and wgrad calls (``record_shapes``)
    to ``$PMV_SMOKE_COUNTS.rank<rank>.shapes.json``. A spawned process
    starts with its counts at 0: its whole run is counted."""
    from pmv_tpu_torch.ops.depthwise import record_shapes
    from pmv_tpu_torch.parallel import distributed

    float32_without_tf32()
    _zero_launch_counts()  # the main path starts here
    with synthetic_videos(EARLIER_RUN_NET_VIDEOS), record_shapes() as shapes:
        distributed._run_process(local_rank, cfg, init_method, func, device_type)
    rank = cfg.SHARD_ID * max(cfg.NUM_GPUS, 1) + local_rank
    counts = f"{os.environ['PMV_SMOKE_COUNTS']}.rank{rank}"
    _write_counts(f"{counts}.json")  # ... and ends here
    with open(f"{counts}.shapes.json", "w") as f:
        json.dump(sorted(set(shapes)), f)


def run_net_counted(counts, argv):
    """``--run-net-counts COUNTS -- ARGV``: ``run_net.main(ARGV)`` in this
    process on ``EARLIER_RUN_NET_VIDEOS`` Synthetic videos, float32 in
    float32, each process's kernel launches written
    beside COUNTS: this one's (a world of one runs here) to
    ``COUNTS.main.json``, each rank's that ``launch_job`` spawns to
    ``COUNTS.rank<rank>.json`` (``_counted_run_process`` runs each)."""
    from pmv_tpu_torch.parallel import distributed
    from pmv_tpu_torch.tools import run_net

    float32_without_tf32()
    os.environ["PMV_SMOKE_COUNTS"] = counts
    distributed._run_process = _counted_run_process
    _zero_launch_counts()
    with synthetic_videos(EARLIER_RUN_NET_VIDEOS):
        run_net.main(argv)
    _write_counts(f"{counts}.main.json")
    return 0


def _dist_run_net_argv(out_dir, max_epoch, shard=None, port=None, recipe="uniformer",
                       batch=4, extra=(), opts=()):
    """Phase 8c's run_net arguments (8e's with ``recipe`` "mvit", ``batch``
    2 and ``extra`` naming dp_sp): the recipe's rect run as phase 6 runs
    it, in float32, one augmented copy a video (AUG.NUM_SAMPLE 1: the
    recipe's 2 copies lie copy-major within each process's rows, so 2
    processes order a step's clips otherwise than one), a 1-view test (the
    recipe's views cut to 1 to keep the script's wall time down), the
    predictions saved, and ``opts``. With ``shard``: that shard of 2 hosts
    of one process each (gloo, both on the one card), ``batch`` videos a
    step each, meeting on ``port``, with ``extra`` opts; else one process
    at twice ``batch``, at the LRs (base, warm-up start, cosine end) that
    BASE_LR_SCALE_NUM_SHARDS gives 2 shards."""
    argv = run_net_argv(recipe, out_dir, max_epoch) + [
        "TRAIN.MIXED_PRECISION", "False", "AUG.NUM_SAMPLE", "1", "TEST.SAVE_RESULTS_PATH",
        "preds.pkl", "TEST.NUM_ENSEMBLE_VIEWS", "1", *opts]
    if shard is None:
        lr = run_net_cfg(_dist_run_net_argv(out_dir, max_epoch, 0, 0, recipe, batch,
                                            opts=opts)).SOLVER
        return argv + ["TRAIN.BATCH_SIZE", str(2 * batch), "TEST.BATCH_SIZE", str(2 * batch),
                       "SOLVER.BASE_LR", repr(lr.BASE_LR), "SOLVER.WARMUP_START_LR",
                       repr(lr.WARMUP_START_LR), "SOLVER.COSINE_END_LR", repr(lr.COSINE_END_LR)]
    at = argv.index("--opts")
    return (argv[:at] + ["--num_shards", "2", "--shard_id", str(shard),
                         "--init_method", f"tcp://127.0.0.1:{port}"]
            + argv[at:] + ["TRAIN.BATCH_SIZE", str(batch), "TEST.BATCH_SIZE", str(batch),
                           "DIST_BACKEND", "gloo", *extra])


def _run_counted(runs, work_dir):
    """Start ``python3 chip_smoke.py --run-net-counts`` for each (name,
    argv) of ``runs`` at once, each with its output in ``work_dir/<name>.log``;
    wait for all, at most DIST_RUN_NET_TIMEOUT_S, then kill each with what it
    spawned. Raises if one failed or hung; returns the wall seconds, every
    count file's launches and every shapes file's K1 and wgrad calls, by
    file name."""
    import subprocess

    procs = []
    t0 = time.perf_counter()
    for name, argv in runs:
        with open(os.path.join(work_dir, f"{name}.log"), "w") as out:
            procs.append((name, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--run-net-counts",
                 os.path.join(work_dir, f"counts_{name}"), "--", *argv],
                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT, start_new_session=True)))
    failed = []
    try:
        for name, proc in procs:
            left = DIST_RUN_NET_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                if proc.wait(timeout=max(left, 1.0)) != 0:
                    failed.append(f"{name} exited {proc.returncode}")
            except subprocess.TimeoutExpired:
                failed.append(f"{name} still running after {DIST_RUN_NET_TIMEOUT_S} s")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    wall = time.perf_counter() - t0
    if failed:
        tails = []
        for name, _ in runs:
            with open(os.path.join(work_dir, f"{name}.log")) as f:
                tails.append(f"--- {name}.log:\n" + f.read()[-3000:])
        raise AssertionError("phase 8c: " + "; ".join(failed) + "\n" + "\n".join(tails))
    counts, shapes = {}, {}
    for name in sorted(os.listdir(work_dir)):
        if name.startswith("counts_"):
            with open(os.path.join(work_dir, name)) as f:
                (shapes if name.endswith(".shapes.json") else counts)[name] = json.load(f)
            os.remove(os.path.join(work_dir, name))
    return wall, counts, shapes


def _json_stats(out_dir):
    with open(os.path.join(out_dir, "stdout.log")) as f:
        lines = f.read().splitlines()
    return lines, [json.loads(line.split("json_stats: ", 1)[1])
                   for line in lines if "json_stats: " in line]


def _test_final(out_dir):
    final = [s for s in _json_stats(out_dir)[1] if s.get("split") == "test_final"]
    if not final:
        raise AssertionError(f"{out_dir}: run_net ended without test_final stats")
    return final[-1]


DISTRIBUTED_RUN_NET = dict(  # phase 8c's pair
    recipe="uniformer", name="distributed", work_name="chip_smoke_distributed_run_net",
    phase="distributed_run_net_2_processes", resume=True)


def _run_net_pairs(card, specs):
    """For each spec of ``specs`` (a dict: "recipe", "work_name", "phase",
    and "name" (the recipe), "batch" (4), "extra" (()), "opts" (()),
    "resume" (False), "held" (None)), ``recipe``'s run_net (``_dist_run_net_argv``, with ``opts``)
    as 2 hosts with ``batch`` videos a step each and the ``extra`` opts,
    beside one process at twice the batch, in ``build/<work_name>``: every spec's 3 processes start at
    once (``_run_counted``), so that the pairs share their start-up. Each
    rank's launches are counted from 0 in its own process (a main path) and
    must equal the one process's, which must equal the count of its steps'
    K1 and wgrad launches (precise BN's forwards among them); test_final must equal the one process's, the
    video scores within 1e-5 and the weights within 2 x lr (phase 3b's gate
    after AdamW); one checkpoint, written once; with ``resume``, the 2
    processes again with SOLVER.MAX_EPOCH 2, which must resume from it.
    With ``held`` (a set of shapes), every K1 and wgrad call of the 2
    processes must be at one of them. Every process's log lands in the first
    spec's directory. Returns each spec's 2-process runs' launches, by its
    name."""
    import pickle

    from pmv_tpu_torch.data.loader import construct_loader

    torch.cuda.empty_cache()  # this process's cached blocks, for the processes below
    pairs = []
    for spec in specs:
        spec = {"batch": 4, "extra": (), "opts": (), "resume": False, "held": None,
                "name": spec["recipe"], **spec}
        recipe, batch, extra = spec["recipe"], spec["batch"], tuple(spec["extra"])
        work_dir = os.path.join("build", spec["work_name"])
        shutil.rmtree(work_dir, ignore_errors=True)
        os.makedirs(work_dir)
        one, two = (os.path.join(work_dir, d) for d in ("one", "two"))
        one_argv = _dist_run_net_argv(one, 1, recipe=recipe, batch=batch, opts=spec["opts"])
        cfg = run_net_cfg(one_argv)
        with synthetic_videos(EARLIER_RUN_NET_VIDEOS):  # as the processes hold it
            n_steps, n_evals, n_tests = (len(construct_loader(cfg, split))
                                         for split in ("train", "val", "test"))
        per_forward = RUN_NET[recipe][1]
        precise = min(cfg.BN.NUM_BATCHES_PRECISE, n_steps) if cfg.BN.USE_PRECISE_STATS else 0
        expected = {"depthwise3x3x3": per_forward * (2 * n_steps + n_evals + n_tests + precise),
                    "depthwise3x3x3_wgrad": per_forward * n_steps}
        pairs.append(dict(spec, work_dir=work_dir, one=one, two=two, one_argv=one_argv,
                          cfg=cfg, n_steps=n_steps, expected=expected, extra=extra))

    def two_processes(pair, max_epoch, tag):
        port = _free_port()
        return [(f"{pair['name']}_{tag}_shard{s}", _dist_run_net_argv(
            pair["two"], max_epoch, s, port, pair["recipe"], pair["batch"], pair["extra"],
            pair["opts"])) for s in (0, 1)]

    def rank_launches(pair, counts, tag):
        phase, expected = pair["phase"], pair["expected"]
        zero = {k: 0 for k in expected}
        prefix = f"counts_{pair['name']}_{tag}_shard"
        ranks = {k: v for k, v in counts.items() if k.startswith(prefix) and ".rank" in k}
        mains = [v for k, v in counts.items() if k.startswith(prefix) and k.endswith(".main.json")]
        if sorted(ranks) != [f"{prefix}{s}.rank{s}.json" for s in (0, 1)] or any(
                v != expected for v in ranks.values()) or any(v != zero for v in mains):
            raise AssertionError(f"{phase} {tag}: launches {counts}, not {expected} a rank")
        return {k: sum(v[k] for v in ranks.values()) for k in expected}

    def rank_shapes(pair, shapes, tag):
        prefix = f"counts_{pair['name']}_{tag}_shard"
        seen = sorted({tuple(s) for name, calls in shapes.items() if name.startswith(prefix)
                       for _, s in calls})
        held = pair["held"]
        if held is not None and (not seen or set(seen) - held):
            raise AssertionError(f"{pair['phase']} {tag}: K1 and wgrad calls at {seen}, not all "
                                 f"of them held against the plain versions ({sorted(held)})")
        return seen

    log_dir = pairs[0]["work_dir"]  # every process's log and counts
    wall, counts, shapes = _run_counted(
        [run for pair in pairs
         for run in [(f"{pair['name']}_one", pair["one_argv"])] + two_processes(pair, 1, "two")],
        log_dir)
    paths = {}
    for pair in pairs:
        phase, cfg, one, two = pair["phase"], pair["cfg"], pair["one"], pair["two"]
        expected = pair["expected"]
        if counts[f"counts_{pair['name']}_one.main.json"] != expected:
            raise AssertionError(f"{phase}: one process launched otherwise than {expected}: "
                                 f"{counts}")
        paths[pair["name"]] = [rank_launches(pair, counts, "two")]
        kernel_shapes = rank_shapes(pair, shapes, "two")
        got, want = _test_final(two), _test_final(one)
        preds = []
        ckpts = []
        for out_dir in (two, one):
            with open(os.path.join(out_dir, "preds.pkl"), "rb") as f:
                preds.append(np.asarray(pickle.load(f)["video_preds"]))
            ckpts.append(torch.load(os.path.join(out_dir, "checkpoints",
                                                 "checkpoint_epoch_00001.pyth"),
                                    map_location="cpu", weights_only=True)["model_state"])
        pair["first_lines"] = _json_stats(two)[0]
        rec = {
            "phase": f"{phase}_gloo", "model": cfg.MODEL.MODEL_NAME, "extra": list(pair["extra"]),
            "card": card, "train_steps": pair["n_steps"], "launches_per_rank": expected,
            "kernel_shapes": kernel_shapes,
            "test_final_2_processes": got, "test_final_1_process": want,
            "video_preds_max_abs_err": float(np.abs(preds[0] - preds[1]).max()),
            "checkpoint_weights_max_abs_err": max(
                float((ckpts[0][k].float() - v.float()).abs().max()) for k, v in ckpts[1].items()),
            "pairs_started_together": [p["name"] for p in pairs], "wall_s": wall}
        log(json.dumps(rec))
        # test_final's accuracies after one epoch from random weights may well
        # be 0 for both; the predictions and the weights say more.
        if got != want:
            raise AssertionError(f"{phase}: 2 processes' test_final {got} != one process's {want}")
        if rec["video_preds_max_abs_err"] > 1e-5:
            raise AssertionError(f"{phase}: 2 processes' video scores differ by "
                                 f"{rec['video_preds_max_abs_err']} from one process's")
        if rec["checkpoint_weights_max_abs_err"] > 2.0001 * cfg.SOLVER.BASE_LR:
            raise AssertionError(f"{phase}: 2 processes' weights differ by "
                                 f"{rec['checkpoint_weights_max_abs_err']} from one process's")
        if sum("Saved checkpoint" in line for line in pair["first_lines"]) != 1 or os.listdir(
                os.path.join(two, "checkpoints")) != ["checkpoint_epoch_00001.pyth"]:
            raise AssertionError(f"{phase}: the 2-process run did not write its one checkpoint "
                                 "once")

    for pair in [p for p in pairs if p["resume"]]:
        phase, two = pair["phase"], pair["two"]
        wall, counts, shapes = _run_counted(two_processes(pair, 2, "resume"), log_dir)
        paths[pair["name"]].append(rank_launches(pair, counts, "resume"))
        rank_shapes(pair, shapes, "resume")
        resumed = _json_stats(two)[0][len(pair["first_lines"]):]
        ckpt = os.path.join(two, "checkpoints", "checkpoint_epoch_00001.pyth")
        if not (any(f"Load from last checkpoint, {ckpt}." in line for line in resumed)
                and any("Start epoch: 2" in line for line in resumed)):
            raise AssertionError(f"{phase}: the 2-process run did not resume from its checkpoint")
        if sorted(os.listdir(os.path.join(two, "checkpoints"))) != [
                "checkpoint_epoch_00001.pyth", "checkpoint_epoch_00002.pyth"]:
            raise AssertionError(f"{phase}: the resumed 2-process run did not write epoch 2's "
                                 "checkpoint")
        log(json.dumps({"phase": f"{phase}_resume", "card": card,
                        "test_final": _test_final(two), "wall_s": wall}))
    return paths


SP_BATCH = 2  # phase 8e's global batch, which both ranks of its model group hold
SP_TIMED_STEPS = 3  # phase 8e's timed bf16 steps, each rank
SP_EVAL_ATOL = 1e-4  # phase 3's eval gate, card against CPU
# Phase 8e's models: MViTv2-S and UniFormer-S (AdamW at TRAIN_LR, no ReLU),
# then the BatchNorm conv families (SGD at their recipes' LR).
SP_RECIPES = ("mvit", "uniformer", "x3d", "slowfast", "csn", "r2plus1d", "avslowfast")


@contextlib.contextmanager
def _held_relus(packed, lay, device):
    """Within the block ``F.relu`` takes, call by call, the decisions of a
    one-process step (``packed``: each mask as (np.packbits of it, its
    shape)), relu(v) = v * decision, as ``grad_witness.relu_decisions``
    holds them: on a rank of the sequence parallelism of ``lay`` the rank's
    planes of a mask over the clip's planes (a visual activation), the
    whole mask where the rank's activation is the whole one (the heads'
    and SE's pooled features, the audio pathway). Yields a list whose entry
    counts the elements whose own sign decides otherwise."""
    import torch.nn.functional as F

    relu, masks, otherwise = F.relu, iter(packed), [0]

    def held(v, inplace=False):
        bits, shape = next(masks)
        mask = torch.from_numpy(np.unpackbits(bits, count=int(np.prod(shape))).reshape(shape))
        if tuple(shape) != tuple(v.shape):
            start, stop = lay.planes(shape[1])
            mask = mask[:, start:stop]
        mask = mask.to(device, torch.bool)
        otherwise[0] += int((mask != (v.detach() > 0)).sum())
        return v * mask

    F.relu = held
    try:
        yield otherwise
    finally:
        F.relu = relu
    if next(masks, None) is not None:
        raise AssertionError("the rank made fewer ReLU calls than the one process")


def _sp_model_of(cfg, case, device, dtype):
    """``case``'s weights on ``device``, computing in ``dtype``: a copy of
    one seeded init for each config (``seeded_model``; the parameters are
    float32 whatever the activations' dtype), its compute dtype set."""
    model = seeded_model(cfg, device, torch.float32)
    model.compute_dtype = dtype
    model.load_state_dict(case["state_dict"])
    return model


def _sp_train(cfg, case, device, dtype, batch, wrap, relus=None):
    """One train step of ``case`` at ``cfg``'s LR on ``batch`` from its
    weights, activations in ``dtype``, the model wrapped for dp_sp where
    ``wrap`` (a rank), the ReLUs held to ``relus`` (``_held_relus``'s
    arguments) where given: (metrics, gradients, state after it), the K1
    and wgrad calls' shapes and launches, and the ReLU elements decided
    otherwise."""
    from pmv_tpu_torch.engine.steps import init_state, make_train_step
    from pmv_tpu_torch.ops.depthwise import record_shapes
    from pmv_tpu_torch.parallel import distributed

    model = _sp_model_of(cfg, case, device, dtype)
    wrapped = distributed.wrap_model(model, "dp_sp", device) if wrap else None
    state = init_state(cfg, model, wrapped=wrapped)
    step = make_train_step(cfg, device=device, seed=0)
    counts = _launch_counts()
    with record_shapes() as shapes, (
            _held_relus(*relus, device) if relus else contextlib.nullcontext([0])) as other:
        metrics = {k: v.cpu() for k, v in step(state, batch, cfg.SOLVER.BASE_LR).items()}
    torch.cuda.synchronize()
    return {"step": (metrics, _grads(model),
                     {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}),
            "shapes": shapes, "launches": _launches_since(counts), "otherwise": other[0]}


def _sp_timed(cfg, case, device, wrap):
    """A bfloat16 model's train step on ``case``'s batch, warm, then
    ``SP_TIMED_STEPS`` timed steps (a main path: launch counts and the T
    collectives' bytes zeroed just before them, read just after): their ms
    a step, launches, K1 and wgrad shapes, and bytes a step."""
    from pmv_tpu_torch.engine.steps import init_state, make_train_step
    from pmv_tpu_torch.ops.depthwise import record_shapes
    from pmv_tpu_torch.parallel import distributed, mesh

    model = _sp_model_of(cfg, case, device, torch.bfloat16)
    wrapped = distributed.wrap_model(model, "dp_sp", device) if wrap else None
    state = init_state(cfg, model, wrapped=wrapped)
    step = make_train_step(cfg, device=device, seed=0)
    step(state, case["batch"], cfg.SOLVER.BASE_LR)  # warm
    torch.cuda.synchronize()
    _zero_launch_counts()  # the main path starts here
    mesh.traffic.update(dict.fromkeys(mesh.traffic, 0))
    t0 = time.perf_counter()
    with record_shapes() as shapes:
        for _ in range(SP_TIMED_STEPS):
            step(state, case["batch"], cfg.SOLVER.BASE_LR)
        torch.cuda.synchronize()
    return {"ms_per_step": (time.perf_counter() - t0) / SP_TIMED_STEPS * 1e3,
            "launches": _launch_counts(),  # ... and ends here
            "timed_shapes": shapes,
            "bytes_per_step": {k: v // SP_TIMED_STEPS for k, v in mesh.traffic.items()}}


def _sp_eval(cfg, case, device):
    """The eval step's scores on ``case``'s clips (and audio), float32, its
    K1 calls' shapes and launches."""
    from pmv_tpu_torch.engine.steps import make_eval_step
    from pmv_tpu_torch.ops.depthwise import record_shapes

    model = _sp_model_of(cfg, case, device, torch.float32)
    counts = _launch_counts()
    with record_shapes() as shapes:
        scores = make_eval_step(cfg, model, device=device)(
            case["eval_frames"], None, case.get("eval_audio")).cpu()
    return {"scores": scores, "eval_shapes": shapes, "eval_launches": _launches_since(counts)}


def _sp_rank(rank, world, port, work_dir, result_q):
    """Phase 8e's rank of a data 1 x model 2 grid over gloo on the one card:
    for each case of ``work_dir/cases.pt`` in turn, the eval step on its
    clips, one float32 dp_sp train step on the global batch, the case's
    check step where it names one (the float32 step with each ReLU taking
    the one process's decisions, or the step in float64 on fewer frames),
    then a bfloat16 model's timed steps (``_sp_timed``). Writes its results
    to ``work_dir/rank<rank>.pt`` and puts None, or its error, on
    ``result_q``."""
    import datetime
    import traceback

    try:
        from pmv_tpu_torch.parallel import distributed, mesh

        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
        float32_without_tf32()
        device = torch.device("cuda", 0)
        cases = torch.load(os.path.join(work_dir, "cases.pt"), weights_only=False)
        distributed.init_distributed(rank, world, f"tcp://127.0.0.1:{port}", device, "gloo",
                                     timeout=datetime.timedelta(seconds=120),
                                     model_size=mesh.model_size(cases[0]["cfg"], world))
        results = []
        for case in cases:
            cfg = case["cfg"]
            lay = mesh.layout(cfg)
            result = {"recipe": case["recipe"], "rank": rank,
                      "layout": [lay.data, lay.data_size, lay.model, lay.model_size],
                      **_sp_eval(cfg, case, device)}
            result["train"] = _sp_train(cfg, case, device, torch.float32, case["batch"], True)
            check = case.get("check")
            if check == "held":
                result["check"] = _sp_train(cfg, case, device, torch.float32, case["batch"],
                                            True, (case["relus"], lay))
            elif check == "float64":
                result["check"] = _sp_train(cfg, case, device, torch.float64,
                                            case["batch64"], True)
            result.update(_sp_timed(cfg, case, device, True))
            results.append(result)
        torch.save(results, os.path.join(work_dir, f"rank{rank}.pt"))
        distributed.destroy()
        result_q.put((rank, None))
    except BaseException:  # reported to the parent, which raises
        result_q.put((rank, traceback.format_exc()))
        raise


def _sp_model(recipe):
    """Phase 8e's model of ``recipe`` (``SP_RECIPES``): (its cfg under
    dp_sp, K1 launches a forward, the shapes at which the kernel phases
    hold K1 and wgrad for its dp_sp paths, with C padded as the wrappers
    pad it, its crop). MViTv2-S, UniFormer-S
    and X3D-M at the PMV rect crop (SWITCH_AUTO, landscape rows) and 16
    frames; SlowFast 8x8 R50 and AVSlowFast 8x8 R50 at their 32 frames of
    224^2 (16 fast and 4 slow a rank), ir-CSN-101 at its 32 (16, 8, 4 and 2
    planes a rank through its T strides), R(2+1)D-50 at its 16."""
    from pmv_tpu_torch.ops import depthwise as dw

    cfg, per_forward, held = {
        "mvit": lambda: (_train_cfg(), MVIT_K1, dw.MVIT_SP_POOL_SHAPES),
        "uniformer": lambda: (uniformer_cfg(), UNIFORMER_K1,
                              dw.UNIFORMER_SP_DPE_SHAPES + dw.UNIFORMER_SP_TEST_DPE_SHAPES),
        "x3d": lambda: (x3d_cfg(), X3D_K1, dw.X3D_SP_DW_SHAPES + dw.X3D_SP_TEST_DW_SHAPES),
        "slowfast": lambda: (slowfast_cfg(), SLOWFAST_K1, ()),
        "csn": lambda: (csn_cfg(), CSN_K1, dw.CSN_SP_DW_SHAPES),
        "r2plus1d": lambda: (csn_cfg(R2PLUS1D_CFG), R2PLUS1D_K1, ()),
        "avslowfast": lambda: (avslowfast_cfg(), AVSLOWFAST_K1, ()),
    }[recipe]()
    # The kernels' shapes: C padded as the wrappers pad it (X3D's 54, 108).
    held = {(*s[:-1], s[-1] + -s[-1] % dw.CHANNEL_MULTIPLE) for s, _ in held}
    crop = (cfg.DATA.TRAIN_CROP_SIZE,) * 2
    if recipe in ("mvit", "uniformer", "x3d"):
        crop = PMV_RECT
        cfg.DATA.TRAIN_CROP_SIZE_RECT = list(PMV_RECT)
        cfg.DATA.TRAIN_CROP_SIZE_RECT_SWITCH_AUTO = True
    cfg.TPU.SHARD_STRATEGY = "dp_sp"
    return cfg, per_forward, held, crop


def _sp_extents(phase, shapes, t_exts, train, per_forward, held, steps=1):
    """Raise unless ``shapes`` (``record_shapes``) hold the model's
    ``per_forward`` K1 calls of a forward, and in a train step as many dx
    calls after them and weight gradients (each ``steps`` times), on the
    planes ``t_exts`` (a rank's planes and a halo plane either side, each
    of the model's stages) and at shapes of ``held``, at which the kernel
    phases hold them against the plain versions."""
    kinds = [kind for kind, _ in shapes]
    counts = [kinds.count(kind) for kind in ("fwd", "dx", "wgrad")]
    want = [steps * per_forward] * 3 if train else [per_forward, 0, 0]
    extents = sorted({shape[1] for _, shape in shapes})
    if counts != want or extents != t_exts:
        raise AssertionError(f"{phase}: K1 forward, dx and wgrad calls {counts} on T "
                             f"{extents}, not {want} on T {t_exts}")
    seen = sorted({shape for _, shape in shapes})
    outside = sorted(set(seen) - held)
    if outside:
        raise AssertionError(f"{phase}: K1 and wgrad calls at {outside}, which the kernel "
                             "phases do not hold against the plain versions")
    return {"k1_forward_dx_wgrad": counts, "t_extent": t_exts, "shapes": seen}


def _sp_reference(recipe):
    """The one-process side of ``recipe``'s phase 8e on the card, and its
    case for the ranks: the global batch of ``SP_BATCH`` (with the
    misaligned audio for AVSlowFast) and eval clips from a seed, the eval
    scores, the float32 train step; for a ReLU net of ``grad_witness
    .RELU_LIMITS`` the check step, as its one-process phases hold it: X3D-M
    and ir-CSN-101 (K1 takes no float64) the float32 step's ReLU decisions,
    which the ranks' step takes again; the others the step in float64 on
    ``FLOAT64_FRAMES`` of the clip; then the bfloat16 step's ms."""
    from pmv_tpu_torch.tools.grad_witness import RELU_LIMITS, relu_decisions, witness_key

    cfg, per_forward, held, crop = _sp_model(recipe)
    rng = np.random.default_rng(15)
    clip = (SP_BATCH, cfg.DATA.NUM_FRAMES, *crop, 3)
    batch = {"frames": rng.integers(0, 256, clip, np.uint8),
             "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, SP_BATCH)}
    case = {"recipe": recipe, "cfg": cfg, "batch": batch,
            "eval_frames": rng.integers(0, 256, clip, np.uint8)}
    if recipe == "avslowfast":
        batch["audio"], batch["audio_mis"] = (av_logmels(cfg, rng, SP_BATCH) for _ in range(2))
        case["eval_audio"] = av_logmels(cfg, rng, SP_BATCH)
    name = witness_key(cfg)
    if name in RELU_LIMITS:
        case["check"] = "held" if per_forward else "float64"
    model = seeded_model(cfg, "cpu", torch.float32)
    case["state_dict"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    ref = _sp_eval(cfg, case, "cuda")
    with relu_decisions() if case.get("check") == "held" else contextlib.nullcontext() as rec:
        ref["train"] = _sp_train(cfg, case, "cuda", torch.float32, batch, False)
    if case.get("check") == "held":
        case["relus"] = [(np.packbits(m.cpu().numpy()), tuple(m.shape)) for m in rec.masks]
        del rec
    elif case.get("check") == "float64":
        case["batch64"] = dict(batch, frames=_fewer_frames(batch["frames"], FLOAT64_FRAMES))
        ref["check"] = _sp_train(cfg, case, "cuda", torch.float64, case["batch64"], False)
    ref.update(_sp_timed(cfg, case, "cuda", False))
    torch.cuda.empty_cache()
    return case, ref, per_forward, held


def _sp_gates(phase, cfg, got, ref, kind, n_params, **extra):
    """A rank's train step ``got`` (metrics, gradients, state) against the
    one process's ``ref``; ``kind`` names the gates: "adamw" phase 3b's
    (``_held_to_step``, MViT and UniFormer); for the ReLU nets, as their
    card-against-CPU phases hold them (``grad_witness``), "free" a float32
    step whose ReLUs decide on their own (the gradients to
    ``RELU_LIMITS``, the grad norm read), "held" a float32 step with the one
    process's ReLU decisions (gradients and grad norm to ``HELD_LIMITS``,
    1e-4 elsewhere), "float64" every gate at 1e-4; then the loss to rtol
    1e-4, top-1 and top-5 equal, the BatchNorm running statistics to 1e-6
    beyond rtol 1e-4 (a float32 step to ``STATS_LIMITS``), and SGD's first
    update linear in the gradient."""
    from pmv_tpu_torch.tools.grad_witness import (
        HELD_LIMITS, RELU_LIMITS, STATS_LIMITS, witness_key)

    if kind == "adamw":
        return _held_to_step(phase, got, ref, cfg.SOLVER.BASE_LR, n_params, **extra)
    name = witness_key(cfg)
    grad_limit = {"free": RELU_LIMITS.get(name, 1e-4), "held": HELD_LIMITS.get(name, 1e-4),
                  "float64": 1e-4}[kind]
    stats_limit = 1e-6 if kind == "float64" else STATS_LIMITS.get(name, 1e-6)
    (gm, gg, gs), (rm, rg, rs) = got, ref
    grad_max = max(float((gg[k] - v).abs().max()) for k, v in rg.items())
    rec = _step_readings(phase, got, ref, gates=kind, grad_limit=grad_limit,
                         bn_stats_limit=stats_limit, **extra)
    torch.testing.assert_close(gm["loss"], rm["loss"], atol=0, rtol=1e-4)
    for key in [k for k in rm if k.endswith("_avs")]:  # AVSlowFast's AVS losses
        torch.testing.assert_close(gm[key], rm[key], atol=1e-6, rtol=1e-4)
    if kind != "free":
        torch.testing.assert_close(gm["grad_norm"], rm["grad_norm"], atol=0, rtol=grad_limit)
    for key in ("top1_err", "top5_err", "nan"):
        if not torch.equal(gm[key], rm[key]):
            raise AssertionError(f"{phase}: {key} {gm[key]} against one process's {rm[key]}")
    if rec["grad_rel_err"] > grad_limit:
        raise AssertionError(f"{phase}: gradients differ by {rec['grad_rel_err']} (relative "
                             f"L2), over {grad_limit}")
    if rec["bn_stats_err_over_rtol"] > stats_limit:
        raise AssertionError(f"{phase}: running statistics {rec['bn_stats_err_over_rtol']} "
                             f"over rtol 1e-4 (limit {stats_limit})")
    lr = cfg.SOLVER.BASE_LR
    if rec["param_max_abs_err"] > (1 + cfg.SOLVER.MOMENTUM) * lr * grad_max * 1.0001 + 1e-6:
        raise AssertionError(f"{phase}: weights differ by {rec['param_max_abs_err']}")
    return rec


def phase_sequence_parallel(card):
    """Phase 8e: every model of ``SP_RECIPES`` under TPU.SHARD_STRATEGY
    dp_sp, in one spawn of two ranks over gloo sharing the one card, a grid
    of data 1 x model 2: full width and depth, each model's frames and crop
    (``_sp_model``) and train recipe (MViT's and UniFormer's RandAugment,
    erasing, MixUp and DropPath; the conv families' head dropout, X3D-M's
    SE blocks, AVSlowFast's misaligned audio and AVS losses), float32, a
    global batch of ``SP_BATCH`` that both ranks hold, each rank half of its
    planes. For each model, each rank's eval scores against the one
    process's on the card within ``SP_EVAL_ATOL``; its train step against
    the one process's on the global batch (``_sp_gates``: phase 3b's for
    MViT and UniFormer; the ReLU nets free in float32 and then held, X3D-M
    and ir-CSN-101 with the one process's ReLU decisions, SlowFast,
    R(2+1)D and AVSlowFast in float64 on ``FLOAT64_FRAMES``); each rank's
    K1, dx and wgrad calls a train step (MViT 17 each, UniFormer 18, X3D-M
    22, ir-CSN-101 30; as many K1 an eval) on its planes and 2 halo planes,
    each at a shape of the model's dp_sp grid (``_sp_model``), which the
    kernel phases hold against the plain versions; then each rank's bf16
    step, timed, beside the one process's, with the bytes its halos,
    gathers and reductions hand to all_reduce. Returns each model's ranks'
    launches of the timed steps."""
    import multiprocessing

    world = 2
    work_dir = os.path.join("build", "chip_smoke_sequence_parallel")
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    cases, refs = [], {}
    for recipe in SP_RECIPES:
        case, *refs[recipe] = _sp_reference(recipe)
        cases.append(case)
    torch.save(cases, os.path.join(work_dir, "cases.pt"))
    ctx = multiprocessing.get_context("spawn")
    result_q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_sp_rank, args=(r, world, port, work_dir, result_q))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        errors = [result_q.get(timeout=600) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    failed = [e for _, e in errors if e]
    if failed:
        raise AssertionError("a phase 8e rank failed:\n" + "\n".join(failed))
    ranks = [torch.load(os.path.join(work_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    launches = {}
    for i, case in enumerate(cases):
        recipe, cfg = case["recipe"], case["cfg"]
        ref, per_forward, held = refs[recipe]
        t_exts = sorted({s[1] for s in held})
        n_params = sum(v.numel() for v in ref["train"]["step"][1].values())
        suffix = "" if recipe == "mvit" else f"_{recipe}"
        for r in (rank[i] for rank in ranks):
            phase = f"sequence_parallel{suffix}_dp_sp_rank{r['rank']}"
            eval_err = float((r["scores"] - ref["scores"]).abs().max())
            extents = _sp_extents(phase, r["train"]["shapes"], t_exts, True, per_forward, held)
            _sp_extents(phase + "_eval", r["eval_shapes"], t_exts, False, per_forward, held)
            _sp_extents(phase + "_timed", r["timed_shapes"], t_exts, True, per_forward, held,
                        steps=SP_TIMED_STEPS)
            extra = dict(model=cfg.MODEL.MODEL_NAME, card=card, layout=r["layout"],
                         global_batch=SP_BATCH, frames=cfg.DATA.NUM_FRAMES,
                         crop=list(case["batch"]["frames"].shape[2:4]),
                         eval_max_abs_err=eval_err, **extents,
                         step_launches=r["train"]["launches"],
                         eval_launches=r["eval_launches"], timed_steps=SP_TIMED_STEPS,
                         ms_per_step_bf16_2_ranks=r["ms_per_step"],
                         ms_per_step_bf16_1_process=ref["ms_per_step"],
                         bytes_per_step_bf16=r["bytes_per_step"], launches=r["launches"],
                         spawn_to_end_s=wall)
            check = case.get("check")
            _sp_gates(f"{phase}_vs_one_process", cfg, r["train"]["step"], ref["train"]["step"],
                      "free" if check else "adamw", n_params, **extra)
            if check == "held":
                _sp_gates(f"{phase}_relus_held_vs_one_process", cfg, r["check"]["step"],
                          ref["train"]["step"], "held", n_params,
                          relu_decisions_otherwise=r["check"]["otherwise"])
            elif check == "float64":
                _sp_gates(f"{phase}_f64_t{FLOAT64_FRAMES}_vs_one_process", cfg,
                          r["check"]["step"], ref["check"]["step"], "float64", n_params)
            if eval_err > SP_EVAL_ATOL:
                raise AssertionError(f"{phase}: eval scores differ by {eval_err}")
            if r["layout"] != [0, 1, r["rank"], 2] or r["recipe"] != recipe:
                raise AssertionError(f"{phase}: layout {r['layout']} of {r['recipe']}")
            if (r["train"]["launches"] != step_launches(per_forward)
                    or r["eval_launches"] != eval_launches(per_forward)):
                raise AssertionError(f"{phase}: launched {r['train']['launches']} a step, "
                                     f"{r['eval_launches']} an eval")
            timed = {k: v * SP_TIMED_STEPS for k, v in step_launches(per_forward).items()}
            if r["launches"] != timed:
                raise AssertionError(f"{phase}: the timed steps launched {r['launches']}, "
                                     f"not {timed}")
        launches[recipe] = {k: sum(rank[i]["launches"][k] for rank in ranks)
                            for k in ranks[0][i]["launches"]}
    return launches


# X3D-M's yaml warms up from an LR of 0.01, 100 x the base LR of the
# run_net phases (1e-4); its dp_sp pair warms up from MViT's and UniFormer's
# 1e-6 instead, so that its gates read the same LRs.
X3D_PAIR_LRS = ("SOLVER.WARMUP_START_LR", "1e-6", "SOLVER.COSINE_END_LR", "1e-6")


def phase_run_net_pairs(card):
    """The ``run_net`` pairs of phases 8e and 8c, their 12 processes started
    at once (``_run_net_pairs``; most of a process's time is its start).
    8e's: ``run_net --num_shards 2 TPU.SHARD_STRATEGY dp_sp`` on MViTv2-S's
    and UniFormer-S's rect recipes, and X3D-M's (exps/PMV/run_X3D_PMV.sh's
    rect_256_192 run, its 256^2 test crop), each against one process under
    8c's gates on 16 Synthetic videos; every K1 and wgrad call of their
    ranks at a shape of the model's dp_sp grid. 8c's: ``run_net`` as a user
    launches it on 2 hosts, two processes of ``run_net --num_shards 2
    --shard_id 0|1 --init_method tcp://...`` with NUM_GPUS 1 and gloo, both
    on the one card (``launch_job`` spawns each rank): UniFormer-S's rect
    recipe at full width, float32, for one epoch (train with ``dp``,
    checkpoint, gathered eval, test) beside one process at twice a
    process's batch; then the 2 processes again with SOLVER.MAX_EPOCH 2,
    which must resume from its checkpoint. Returns (8c's 2-process runs'
    launches, 8e's by model)."""
    specs = [dict(recipe=recipe, work_name=f"chip_smoke_sequence_parallel{suffix}_run_net",
                  phase=f"sequence_parallel{suffix}_run_net", batch=2,
                  extra=("TPU.SHARD_STRATEGY", "dp_sp"), held=_sp_model(recipe)[2])
             for recipe, suffix in (("mvit", ""), ("uniformer", "_uniformer"),
                                    ("x3d", "_x3d"))]
    specs[-1]["opts"] = X3D_PAIR_LRS
    paths = _run_net_pairs(card, specs + [DISTRIBUTED_RUN_NET])
    return paths.pop("distributed"), paths


# Planted in a wrapper to see what phase 8b's gates catch
# (``--plant-wrapper-faults``): gradients reduced in bfloat16 (DDP's
# bf16_compress_hook; FSDP2's reduce_dtype), FSDP2 gathering bfloat16
# parameters (param_dtype), and the gradients x 2, as a world of 2 leaves
# them without its division (a DDP comm hook; FSDP2's divide factor).
WRAPPER_FAULTS = {"dp": ("bf16_reduce", "unscaled"),
                  "fsdp": ("bf16_reduce", "bf16_params", "unscaled")}


@contextlib.contextmanager
def _fsdp_policy(fault):
    """FSDP2's ``fully_shard`` with the mixed-precision policy of ``fault``
    (else as it is) while the block is open."""
    import torch.distributed.fsdp as fsdp

    policy = {"bf16_reduce": dict(reduce_dtype=torch.bfloat16),
              "bf16_params": dict(param_dtype=torch.bfloat16)}.get(fault)
    original = fsdp.fully_shard
    if policy is not None:
        fsdp.fully_shard = functools.partial(
            original, mp_policy=fsdp.MixedPrecisionPolicy(**policy))
    try:
        yield
    finally:
        fsdp.fully_shard = original


def _plant(model, wrapped, fault):
    """``fault`` (of WRAPPER_FAULTS) in a wrapped model, where it is not
    planted at wrapping (``_fsdp_policy``): DDP's comm hooks, FSDP2's
    gradient divide factor."""
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks
    from torch.distributed.fsdp import FSDPModule

    ddp = isinstance(wrapped, torch.nn.parallel.DistributedDataParallel)
    if fault == "bf16_reduce" and ddp:
        wrapped.register_comm_hook(None, default_hooks.bf16_compress_hook)
    elif fault == "unscaled" and ddp:
        wrapped.register_comm_hook(None, lambda state, bucket: default_hooks.allreduce_hook(
            None, bucket).then(lambda fut: fut.value() * 2.0))
    elif fault == "unscaled":
        for m in model.modules():
            if isinstance(m, FSDPModule):
                m.set_gradient_divide_factor(0.5)


def _wrapped_steps(cfg, strategy, batch, device, timed, fault=None, lr=TRAIN_LR):
    """From the seeded init (``seeded_model``), one train step of ``cfg``'s
    model (MViTv2-S; or an SSL model, through its step) at ``lr`` under
    ``strategy`` ("dp", "fsdp"; else unwrapped), with ``fault`` planted in
    the wrapper when given, then ``timed`` more (a main path: launch counts
    zeroed just before them, read just after). Returns (metrics, gradients,
    state) after the first, the timed steps' ms a step and launches, and
    the count of weights."""
    from pmv_tpu_torch.engine import ssl_steps
    from pmv_tpu_torch.engine.steps import init_state, make_train_step
    from pmv_tpu_torch.parallel import distributed

    model = seeded_model(cfg, device)
    wrapped = None
    if strategy in ("dp", "fsdp"):
        with _fsdp_policy(fault):
            wrapped = distributed.wrap_model(model, strategy, device)
        _plant(model, wrapped, fault)
    state = init_state(cfg, model, wrapped=wrapped)
    make = {"MaskMViT": ssl_steps.make_masked_train_step,
            "ContrastiveModel": ssl_steps.make_ssl_train_step}.get(cfg.MODEL.MODEL_NAME,
                                                                   make_train_step)
    step = make(cfg, device=device, seed=0)
    metrics = {k: v.cpu() for k, v in step(state, batch, lr).items()}
    first = (metrics,
             {k: distributed.full(p.grad).detach().float().cpu()
              for k, p in model.named_parameters()},
             {k: distributed.full(v).detach().cpu() for k, v in model.state_dict().items()})
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    _zero_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    for _ in range(timed):
        step(state, batch, lr)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / max(timed, 1) * 1e3
    launches = _launch_counts()  # ... and ends here
    del state, model, wrapped
    torch.cuda.empty_cache()
    return first, ms, launches, n_params


@contextlib.contextmanager
def _nccl_world_of_one():
    """A world of one over NCCL on the card, cuDNN deterministic, while the
    block is open; yields MViTv2-S's bfloat16 and float32 cfgs, a batch of 8
    and the device."""
    from pmv_tpu_torch.parallel import distributed

    cfg = _train_cfg()  # bfloat16
    f32 = cfg.clone()
    f32.TRAIN.MIXED_PRECISION = False
    rng = np.random.default_rng(9)
    size = cfg.DATA.TRAIN_CROP_SIZE
    batch = {"frames": rng.integers(0, 256, (8, cfg.DATA.NUM_FRAMES, size, size, 3), np.uint8),
             "labels": rng.integers(0, cfg.MODEL.NUM_CLASSES, 8)}
    device = torch.device("cuda", 0)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    distributed.init_distributed(0, 1, f"tcp://127.0.0.1:{_free_port()}", device, "nccl")
    try:
        yield cfg, f32, batch, device
    finally:
        distributed.destroy()
        torch.backends.cudnn.deterministic = deterministic


# bfloat16 gradients of the dp and fsdp steps against the unwrapped step
# (relative L2). Sound wrappers read as a second unwrapped run does, the
# bfloat16 floor of atomic sums that differ from run to run: 3.30e-3 to
# 3.75e-3 on an H100 80GB HBM3 at 700 W (PERF.md). Of the planted faults
# (``--plant-wrapper-faults``) the unscaled gradients read 1.0; a bfloat16
# reduction reads 3.47e-3 (dp) and 3.58e-3 (fsdp), inside the floor, and
# only the float32 gate tells it apart (1.66e-3 against 1e-4); FSDP2's
# bfloat16 parameters stop the step.
BF16_WRAPPER_LIMIT = 1e-2


def phase_distributed_nccl(card):
    """Phase 8b: a world of one over NCCL, made here. MViTv2-S (the bench
    recipe, batch 8, cuDNN deterministic): the ``dp`` and the ``fsdp`` step
    against the unwrapped step from the same weights and draws, in float32
    under phase 3b's gates, and in bfloat16 with the gradients within
    BF16_WRAPPER_LIMIT (beside a second unwrapped run's reading: bfloat16
    gradients summed by atomics differ from run to run); then 5 timed
    bfloat16 steps of each (a main path): the wrappers' overhead in ms.
    Returns the launches of the wrapped timed steps."""
    with _nccl_world_of_one() as (cfg, f32, batch, device):
        exact = {s: _wrapped_steps(f32, s, batch, device, 0) for s in (None, "dp", "fsdp")}
        timed = {s: _wrapped_steps(cfg, s, batch, device, DIST_TIMED_STEPS)
                 for s in (None, "again", "dp", "fsdp")}
    for strategy in ("dp", "fsdp"):
        _held_to_step(f"distributed_nccl_world1_{strategy}_vs_unwrapped_f32",
                      exact[strategy][0], exact[None][0], TRAIN_LR, exact[None][3],
                      model=f32.MODEL.MODEL_NAME, card=card, batch=8)
    plain_ms = timed[None][1]
    for strategy in ("again", "dp", "fsdp"):
        first, ms, launches, _ = timed[strategy]
        rec = _step_readings(f"distributed_nccl_world1_{strategy}_vs_unwrapped_bf16", first,
                             timed[None][0], model=cfg.MODEL.MODEL_NAME, card=card, batch=8,
                             ms_per_step=ms, unwrapped_ms_per_step=plain_ms,
                             overhead_ms=ms - plain_ms, launches=launches,
                             limit=BF16_WRAPPER_LIMIT)
        if strategy != "again" and rec["grad_rel_err"] > BF16_WRAPPER_LIMIT:
            raise AssertionError(f"{strategy}: bfloat16 gradients differ by "
                                 f"{rec['grad_rel_err']} (relative L2)")
        expected = {k: v * DIST_TIMED_STEPS for k, v in step_launches(MVIT_K1).items()}
        if launches != expected:
            raise AssertionError(f"{strategy}: {launches} launches, not {expected}")
    return [timed["dp"][2], timed["fsdp"][2]]


SSL_FSDP_TIMED_STEPS = 3  # phase 8f's timed bf16 steps of each SSL model and wrapper
SSL_FSDP_F32_BATCH = 2  # videos (MoCo: of two views) in 8f's float32 steps


def phase_ssl_fsdp_nccl(card):
    """Phase 8f: the SSL steps under ``fsdp`` at a world of one over NCCL
    (cuDNN deterministic), as phase 8b holds the supervised step: MoCo on
    Slow R50 (the momentum encoder sharded as the online one, its key
    forwards through FSDP's gathers, the EMA on the shards) and MaskFeat PT
    (MaskMViT's blocks and decoder sharded, 14 K1 a forward), each at full
    width from the seeded init: the fsdp step against the unwrapped one in
    float32 at ``SSL_FSDP_F32_BATCH`` under phase 3b's gates (``_held_to_step``),
    the SSL state (momentum encoder, queue, bank) to 1e-5; then bfloat16 at
    batch 8, the gradients within BF16_WRAPPER_LIMIT (beside a second
    unwrapped run's reading) and ``SSL_FSDP_TIMED_STEPS`` timed steps of each
    (a main path): ms a step and the wrapper's overhead. NCCL cannot place
    two ranks on one card; FSDP2's reduce-scatter and all-gather of CUDA
    tensors have no gloo route, so the 2-rank fsdp equality is held on the
    CPU (tests/test_torch_port_distributed.py). Returns the fsdp timed
    steps' launches."""
    moco, maskfeat = ssl_cfg("moco"), maskfeat_cfg()
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = (
        ("moco", moco, SLOW_K1, lambda cfg, b: _ssl_device_batch(cfg, b, 13)),
        ("maskfeat", maskfeat, MASKFEAT_K1, lambda cfg, b: {"frames": torch.randint(
            0, 256, (b, *_maskfeat_clip(cfg)), dtype=torch.uint8, device="cuda",
            generator=gen)}),
    )
    paths = []
    with _nccl_world_of_one() as (_, _, _, device):
        for name, cfg, per_forward, batch_of in cases:
            f32 = cfg.clone()
            f32.TRAIN.MIXED_PRECISION = False
            lr = cfg.SOLVER.BASE_LR
            small = batch_of(f32, SSL_FSDP_F32_BATCH)
            exact = {s: _wrapped_steps(f32, s, small, device, 0, lr=lr) for s in (None, "fsdp")}
            big = batch_of(cfg, SSL_BATCH if name == "moco" else MASKFEAT_BATCH)
            timed = {s: _wrapped_steps(cfg, s, big, device, SSL_FSDP_TIMED_STEPS, lr=lr)
                     for s in (None, "again", "fsdp")}
            (_, _, got_state), (_, _, want_state) = exact["fsdp"][0], exact[None][0]
            ssl = [k for k in want_state if k.split(".")[0] in ("momentum", "queue", "bank")]
            ssl_err = max((float((got_state[k].float() - want_state[k].float()).abs().max())
                           for k in ssl), default=0.0)
            _held_to_step(f"ssl_fsdp_nccl_world1_{name}_vs_unwrapped_f32", exact["fsdp"][0],
                          exact[None][0], lr, exact[None][3],
                          model=cfg.MODEL.MODEL_NAME, card=card, batch=SSL_FSDP_F32_BATCH,
                          ssl_state_max_abs_err=ssl_err, ssl_tensors=len(ssl))
            if ssl_err > 1e-5 or (name == "moco" and not ssl):
                raise AssertionError(f"8f {name}: the SSL state ({len(ssl)} tensors) differs "
                                     f"by {ssl_err}")
            plain_ms = timed[None][1]
            expected = {k: v * SSL_FSDP_TIMED_STEPS
                        for k, v in step_launches(per_forward).items()}
            for strategy in ("again", "fsdp"):
                first, ms, launches, _ = timed[strategy]
                rec = _step_readings(f"ssl_fsdp_nccl_world1_{name}_{strategy}_vs_unwrapped_bf16",
                                     first, timed[None][0], model=cfg.MODEL.MODEL_NAME,
                                     card=card, batch=len(big["frames"]), ms_per_step=ms,
                                     unwrapped_ms_per_step=plain_ms, overhead_ms=ms - plain_ms,
                                     launches=launches, limit=BF16_WRAPPER_LIMIT)
                if strategy == "fsdp" and rec["grad_rel_err"] > BF16_WRAPPER_LIMIT:
                    raise AssertionError(f"8f {name}: bfloat16 gradients differ by "
                                         f"{rec['grad_rel_err']} (relative L2)")
                if launches != expected:
                    raise AssertionError(f"8f {name} {strategy}: {launches} launches, not "
                                         f"{expected}")
            paths.append(timed["fsdp"][2])
    return paths


def plant_wrapper_faults(card):
    """``--plant-wrapper-faults``: phase 8b's first step in float32 and in
    bfloat16, the sound wrappers and each planted fault of WRAPPER_FAULTS
    against the unwrapped step, beside a second unwrapped run: the readings
    that phase 8b's limits have to tell apart. Logs them; a fault that
    raises is logged with its error."""
    with _nccl_world_of_one() as (cfg, f32, batch, device):
        for tag, c in (("f32", f32), ("bf16", cfg)):
            ref = _wrapped_steps(c, None, batch, device, 0)[0]
            runs = [("again", None, None), ("dp", "dp", None), ("fsdp", "fsdp", None)]
            runs += [(f"{s}_{f}", s, f) for s, faults in WRAPPER_FAULTS.items() for f in faults]
            for name, strategy, fault in runs:
                phase = f"planted_{name}_vs_unwrapped_{tag}"
                try:
                    got = _wrapped_steps(c, strategy, batch, device, 0, fault)[0]
                except Exception as e:  # logged: a fault may stop the step
                    log(json.dumps({"phase": phase, "error": str(e).splitlines()[0]}))
                    continue
                _step_readings(phase, got, ref, card=card, fault=fault,
                               bf16_limit=BF16_WRAPPER_LIMIT)


# Visualization, the demos and the inflated UniFormer-S, phases
# 9a-9e. The card's host has neither matplotlib nor moviepy (nor FFmpeg):
# its visualization writes the weight histograms and leaves
# CONFUSION_MATRIX and HISTOGRAM off (``plot_eval`` raises there, checked in
# 9b), tensorboard skips the videos, and the demos read and write frames in
# memory (``FrameSource``, ``FrameSink``).

M19_DIR = os.path.join("build", "chip_smoke_m19")
GRADCAM_BATCH = 2  # 9a's clips, card against CPU
DEMO_FRAMES = 150  # 9c's source: 2 windows of 16 x 4 frames and 22 more
DEMO_SIZE = (240, 320)  # 9c's frames, H x W
DEMO_BUFFER = 8  # DEMO.BUFFER_SIZE in 9c
AVA_DEMO_FRAMES = 90  # 9d's source at 30 fps: keyframes at seconds 901 and 902
AVA_DEMO_SIZE = (256, 455)


class FrameSource:
    """Frames in memory with the surface of ``native/binding.VideoReader``
    that the demos read (the card's host has no FFmpeg to decode a file)."""

    def __init__(self, frames, fps):
        self.frames, self.fps = frames, float(fps)
        self.num_frames, self.height, self.width = frames.shape[:3]

    def read_frames(self, indices):
        return self.frames[np.sort(np.asarray(indices, np.int64))]

    def close(self):
        pass


class FrameSink:
    """The demos' output sink: keeps the frames written (``binding.
    write_test_video``'s signature)."""

    def __init__(self):
        self.frames, self.fps, self.path = None, None, None

    def __call__(self, path, frames, fps):
        self.path, self.frames, self.fps = path, np.asarray(frames), fps


def mvit_run_net_checkpoint():
    """Phase 6-7's last MViTv2-S checkpoint (the PMV rect recipe)."""
    from pmv_tpu_torch.utils import checkpoint as cu

    last = cu.get_last_checkpoint(os.path.join("build", "chip_smoke_run_net"))
    if last is None:
        raise AssertionError("phase 6 left no MViTv2-S checkpoint")
    return last


def phase_gradcam(card, checkpoint):
    """9a: Grad-CAM (``visualization/gradcam.py``) of full-width MViTv2-S
    16x4 on phase 6's checkpoint (the PMV rect crop), float32 at batch
    ``GRADCAM_BATCH``, card against CPU: the maps to atol 1e-4, the scores
    to phase 3's 1e-4, 17 K1 and 0 wgrad launches (the gradient stops at the
    tap). Returns the card's launches."""
    from pmv_tpu_torch.engine.steps import make_eval_preprocess_fn
    from pmv_tpu_torch.utils import checkpoint as cu
    from pmv_tpu_torch.visualization.gradcam import gradcam

    cfg = run_net_cfg(run_net_argv("mvit", M19_DIR, 1))
    cfg.TRAIN.MIXED_PRECISION = False
    h, w = cfg.DATA.TEST_CROP_SIZE_RECT
    frames = torch.from_numpy(np.random.default_rng(19).integers(
        0, 256, (GRADCAM_BATCH, cfg.DATA.NUM_FRAMES, h, w, 3), np.uint8))
    out = {}
    for device in ("cuda", "cpu"):
        model = seeded_model(cfg, device)
        cu.load_checkpoint(checkpoint, model=model)
        x = make_eval_preprocess_fn(cfg, device)(frames.to(device))
        before = _launch_counts()
        t0 = time.perf_counter()
        maps, preds = gradcam(model, x)
        maps, preds = maps.cpu(), preds.cpu()
        out[device] = (maps, preds, _launches_since(before), time.perf_counter() - t0)
    (maps, preds, launches, gpu_s), (cpu_maps, cpu_preds, _, cpu_s) = out["cuda"], out["cpu"]
    rec = {"phase": "gradcam_f32_card_vs_cpu", "model": cfg.MODEL.MODEL_NAME, "card": card,
           "checkpoint": checkpoint, "batch": GRADCAM_BATCH, "crop": [h, w],
           "maps_shape": list(maps.shape), "maps_max_abs_err": float((maps - cpu_maps).abs().max()),
           "scores_max_abs_err": float((preds - cpu_preds).abs().max()),
           "argmax_equal": bool(torch.equal(preds.argmax(-1), cpu_preds.argmax(-1))),
           "launches": launches, "card_s": gpu_s, "cpu_s": cpu_s}
    log(json.dumps(rec))
    if launches != eval_launches(MVIT_K1):
        raise AssertionError(f"9a: Grad-CAM launched {launches}, not one forward's")
    if not (torch.isfinite(maps).all() and maps.min() >= 0 and maps.max() <= 1):
        raise AssertionError("9a: Grad-CAM maps outside [0, 1]")
    if not rec["argmax_equal"] or rec["scores_max_abs_err"] > 1e-4:
        raise AssertionError(f"9a: scores differ from the CPU's: {rec}")
    if rec["maps_max_abs_err"] > 1e-4:
        raise AssertionError(f"9a: Grad-CAM maps differ from the CPU's by "
                             f"{rec['maps_max_abs_err']}")
    return launches


def _event_tags(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir, size_guidance={"histograms": 0})
    acc.Reload()
    return acc.Tags()


def phase_visualization_run_net(card, checkpoint):
    """9b, a main path: ``run_net`` on configs/Kinetics/MVITv2_S_16x4.yaml
    (phase 6's PMV rect options) with TRAIN.ENABLE and TEST.ENABLE False,
    TENSORBOARD.ENABLE with MODEL_VIS (MODEL_WEIGHTS, GRAD_CAM, INPUT_VIDEO)
    and WRONG_PRED_VIS, on ``EARLIER_RUN_NET_VIDEOS`` Synthetic videos and
    phase 6's checkpoint, bfloat16 (the yaml's): a weight histogram of every
    parameter in the event file, 17 K1 and 0 wgrad a test batch (Grad-CAM's
    forwards). Then ``plot_eval`` with CONFUSION_MATRIX on: it must raise
    where matplotlib is absent and write the figure where it is present.
    Returns the launches."""
    import importlib.util

    from pmv_tpu_torch.data.loader import construct_loader
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.tools import run_net
    from pmv_tpu_torch.tools.visualization import MAX_BATCHES
    from pmv_tpu_torch.visualization.tensorboard_vis import TensorboardWriter

    out_dir = os.path.join(M19_DIR, "visualization")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = run_net_argv("mvit", out_dir, 1) + [
        "TRAIN.ENABLE", "False", "TEST.ENABLE", "False", "TEST.CHECKPOINT_FILE_PATH", checkpoint,
        "TENSORBOARD.ENABLE", "True", "TENSORBOARD.MODEL_VIS.ENABLE", "True",
        "TENSORBOARD.MODEL_VIS.MODEL_WEIGHTS", "True", "TENSORBOARD.MODEL_VIS.GRAD_CAM.ENABLE",
        "True", "TENSORBOARD.MODEL_VIS.INPUT_VIDEO", "True",
        "TENSORBOARD.WRONG_PRED_VIS.ENABLE", "True"]
    cfg = run_net_cfg(argv)
    with synthetic_videos(EARLIER_RUN_NET_VIDEOS):
        test_cfg = cfg.clone()
        test_cfg.TEST.PROCESS = True
        batches = min(len(construct_loader(test_cfg, "test")), MAX_BATCHES)
        torch.cuda.synchronize()
        _zero_launch_counts()  # the main path starts here
        t0 = time.perf_counter()
        run_net.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_counts()  # ... and ends here
    log_dir = os.path.join(out_dir, "runs-synthetic")
    tags = _event_tags(log_dir)
    names = [n for n, _ in build_model(cfg, device="cpu").named_parameters()]
    has_matplotlib = importlib.util.find_spec("matplotlib") is not None
    cfg.TENSORBOARD.CONFUSION_MATRIX.ENABLE = True
    cfg.TENSORBOARD.LOG_DIR = "plot_eval"
    writer = TensorboardWriter(cfg)
    try:
        writer.plot_eval(np.eye(cfg.MODEL.NUM_CLASSES)[:4], np.arange(4), global_step=0)
        plot_eval = "written"
    except ModuleNotFoundError as e:
        plot_eval = f"raised {type(e).__name__}: {e}"
    writer.close()
    rec = {"phase": "visualization_run_net", "card": card, "checkpoint": checkpoint,
           "test_batches": batches, "wall_s": wall, "launches": launches,
           "histograms": len(tags["histograms"]), "parameters": len(names),
           "images": tags["images"], "matplotlib": has_matplotlib, "plot_eval": plot_eval}
    log(json.dumps(rec))
    if sorted(tags["histograms"]) != sorted(f"weights/{n}" for n in names):
        raise AssertionError(f"9b: the histograms are not the model's parameters: {tags}")
    if launches != {k: batches * v for k, v in eval_launches(MVIT_K1).items()}:
        raise AssertionError(f"9b: {launches} launched over {batches} Grad-CAM forwards")
    if (plot_eval == "written") != has_matplotlib:
        raise AssertionError(f"9b: plot_eval {plot_eval} with matplotlib {has_matplotlib}")
    return launches


class _RecordedVis:
    """An ``AsyncVis`` that records the frames and scores of each task it is
    handed, before it draws them."""

    @staticmethod
    def make(base, tasks):
        class Recording(base):
            def put(self, task):
                tasks.append((task.id, np.array(task.frames), None if task.action_preds is None
                              else np.array(task.action_preds)))
                super().put(task)

        return Recording


def demo_cfg(workers):
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(MVIT_CFG)
    cfg.merge_from_list([
        "NUM_GPUS", "1", "TRAIN.MIXED_PRECISION", "False", "DEMO.ENABLE", "True",
        "DEMO.INPUT_VIDEO", "seeded.avi", "DEMO.BUFFER_SIZE", str(DEMO_BUFFER),
        "DEMO.NUM_CLIPS_SKIP", "1", "DEMO.NUM_VIS_INSTANCES", str(workers),
        "TEST.CHECKPOINT_FILE_PATH", "", "OUTPUT_DIR", os.path.join(M19_DIR, "demo")])
    return cfg


def phase_demo(card):
    """9c, a main path: the demo (``visualization/demo.py``) on full-width
    MViTv2-S 16x4 (configs/Kinetics/MVITv2_S_16x4.yaml, random weights from
    its seed, float32) over ``DEMO_FRAMES`` seeded frames in memory: windows
    of 16 x 4 frames with DEMO.BUFFER_SIZE ``DEMO_BUFFER`` and
    NUM_CLIPS_SKIP 1, run with ``AsyncVis`` in this process and with 2
    spawned workers. Every source frame comes out once, each predicted
    window's scores equal the eval step's on the same clip (atol 1e-5), the
    2 workers' frames equal the in-process ones, 17 K1 a predicted window.
    Returns the launches of both runs."""
    from pmv_tpu_torch.engine.steps import make_eval_step
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.visualization import demo as demo_mod

    source = np.random.default_rng(9).integers(0, 256, (DEMO_FRAMES, *DEMO_SIZE, 3), np.uint8)
    runs = {}
    torch.cuda.synchronize()
    _zero_launch_counts()  # the main path starts here
    for workers in (0, 2):
        tasks, sink = [], FrameSink()
        base = demo_mod.AsyncVis
        demo_mod.AsyncVis = _RecordedVis.make(base, tasks)
        try:
            t0 = time.perf_counter()
            demo_mod.demo(demo_cfg(workers), source=FrameSource(source, 30), sink=sink)
            runs[workers] = (tasks, sink, time.perf_counter() - t0)
        finally:
            demo_mod.AsyncVis = base
    torch.cuda.synchronize()
    launches = _launch_counts()  # ... and ends here
    cfg = demo_cfg(0)
    model = build_model(cfg, device="cuda", seed=cfg.RNG_SEED)
    eval_step = make_eval_step(cfg, model, device="cuda")
    (tasks, sink, wall), (tasks_2, sink_2, wall_2) = runs[0], runs[2]
    predicted = [t for t in tasks if t[2] is not None]
    errs = []
    for _, frames, preds in predicted:
        clip = demo_mod.window_clip(frames, cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE)
        errs.append(float(np.abs(eval_step(clip[None]).float().cpu().numpy()[0] - preds).max()))
    seq_len = cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE
    windows = -(-DEMO_FRAMES // seq_len)
    rec = {"phase": "demo_mvit", "card": card, "frames_in": DEMO_FRAMES,
           "frames_out": len(sink.frames), "frames_out_2_workers": len(sink_2.frames),
           "windows": [t[0] for t in tasks], "predicted": [t[0] for t in predicted],
           "scores_max_abs_err_vs_eval_step": errs,
           "frames_equal_2_workers": bool(np.array_equal(sink.frames, sink_2.frames)),
           "wall_s": wall, "wall_s_2_workers": wall_2, "launches": launches}
    log(json.dumps(rec))
    if [t[0] for t in tasks] != list(range(windows)) or len(predicted) != (windows + 1) // 2:
        raise AssertionError(f"9c: windows {rec['windows']}, predicted {rec['predicted']}")
    if not (len(sink.frames) == len(sink_2.frames) == DEMO_FRAMES):
        raise AssertionError(f"9c: {len(sink.frames)} frames out of {DEMO_FRAMES}")
    if max(errs) > 1e-5:
        raise AssertionError(f"9c: window scores differ from the eval step's by {max(errs)}")
    if not rec["frames_equal_2_workers"] or [t[0] for t in tasks_2] != [t[0] for t in tasks]:
        raise AssertionError("9c: the 2 workers drew otherwise than the in-process pool")
    if launches != {k: 2 * len(predicted) * v for k, v in eval_launches(MVIT_K1).items()}:
        raise AssertionError(f"9c: {launches} for 2 x {len(predicted)} predicted windows")
    return launches


def phase_ava_demo(card):
    """9d, a main path: the AVA demo (``visualization/ava_demo.py``) on
    SlowFast 32x2 R50 AVA (configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml, phase
    6a's checkpoint) over ``AVA_DEMO_FRAMES`` seeded frames of 455 x 256 in
    memory at 30 fps and a seeded DEMO.PREDS_BOXES file (2 boxes at each of
    seconds 901 and 902): each keyframe's box scores equal the detection
    eval step's on the same clip (atol 1e-5), every source frame comes out
    once (SLOWMO 1), 0 K1. Returns the launches."""
    from pmv_tpu_torch.data import transform
    from pmv_tpu_torch.data.ava import MAX_BOXES, _scale_box_ratio, get_sequence
    from pmv_tpu_torch.engine.steps import make_detection_eval_step
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.utils import checkpoint as cu
    from pmv_tpu_torch.visualization import ava_demo as ava_mod

    out_dir = os.path.join(M19_DIR, "ava_demo")
    os.makedirs(out_dir, exist_ok=True)
    boxes = os.path.join(out_dir, "preds.csv")
    rng = np.random.default_rng(18)
    with open(boxes, "w") as f:
        for sec in (901, 902):
            for _ in range(2):
                x1, y1 = rng.uniform(0.0, 0.5, 2)
                f.write(f"seeded,{sec},{x1:.3f},{y1:.3f},{x1 + 0.4:.3f},{y1 + 0.45:.3f},,0.95\n")
    checkpoint = cu.get_last_checkpoint(os.path.join("build", "chip_smoke_ava", "run_slowfast"))
    cfg = ava_cfg()
    cfg.merge_from_list(["DEMO.ENABLE", "True", "DEMO.INPUT_VIDEO", "seeded.avi",
                         "DEMO.PREDS_BOXES", boxes, "DEMO.STARTING_SECOND", "900",
                         "TEST.CHECKPOINT_FILE_PATH", checkpoint or "",
                         "OUTPUT_DIR", out_dir])
    source = rng.integers(0, 256, (AVA_DEMO_FRAMES, *AVA_DEMO_SIZE, 3), np.uint8)
    merged, sink = [], FrameSink()
    merge = ava_mod.merge_pred_gt_boxes
    ava_mod.merge_pred_gt_boxes = lambda *a: merged.append(a[0]) or merge(*a)
    try:
        torch.cuda.synchronize()
        _zero_launch_counts()  # the main path starts here
        t0 = time.perf_counter()
        ava_mod.ava_demo(cfg, source=FrameSource(source, 30), sink=sink)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_counts()  # ... and ends here
    finally:
        ava_mod.merge_pred_gt_boxes = merge
    preds, = merged
    model = build_model(cfg, device="cuda", seed=0)
    cu.load_test_checkpoint(cfg, model)
    det_step = make_detection_eval_step(cfg, model, device="cuda")
    t, stride, crop = cfg.DATA.NUM_FRAMES, cfg.DATA.SAMPLING_RATE, cfg.DATA.TEST_CROP_SIZE
    errs = {}
    for kf, (kf_boxes, scores) in sorted(preds.items()):
        seq = get_sequence(kf, t * stride // 2, stride, AVA_DEMO_FRAMES)[:t]
        clip = source[np.sort(seq)].astype(np.float32)
        n = len(kf_boxes)
        boxes_in = np.zeros((1, MAX_BOXES, 4), np.float32)
        boxes_in[0, :n] = np.asarray(kf_boxes, np.float32) * _scale_box_ratio(
            *AVA_DEMO_SIZE, crop)
        mask = np.zeros((1, MAX_BOXES), bool)
        mask[0, :n] = True
        want = det_step(np.clip(transform.short_side_scale(clip, crop), 0, 255).astype(
            np.uint8)[None], boxes_in, mask).float().cpu().numpy()[0, :n]
        errs[kf] = float(np.abs(want - np.asarray(scores)).max())
    rec = {"phase": "ava_demo_slowfast", "card": card, "checkpoint": checkpoint,
           "keyframes": sorted(preds), "boxes": {k: len(v[0]) for k, v in preds.items()},
           "scores_max_abs_err_vs_eval_step": errs, "frames_in": AVA_DEMO_FRAMES,
           "frames_out": len(sink.frames), "wall_s": wall, "launches": launches}
    log(json.dumps(rec))
    if sorted(preds) != [30, 60] or any(len(v[0]) != 2 for v in preds.values()):
        raise AssertionError(f"9d: keyframes {rec['keyframes']}, boxes {rec['boxes']}")
    if max(errs.values()) > 1e-5:
        raise AssertionError(f"9d: box scores differ from the eval step's: {errs}")
    if len(sink.frames) != AVA_DEMO_FRAMES:
        raise AssertionError(f"9d: {len(sink.frames)} frames out of {AVA_DEMO_FRAMES}")
    if launches != eval_launches(AVA_K1):
        raise AssertionError(f"9d: {launches} launched; SlowFast has no conv on K1")
    return launches


def write_image_checkpoint(model, path, seed):
    """``model``'s weights as the reference's image checkpoint of it: each
    5-D conv weight's middle T plane as a 4-D [O, I, H, W] kernel, the head
    of 1000 classes (drawn from ``seed``), BatchNorm statistics drawn from
    ``seed``, under "model" (the layout of uniformer_small_in1k.pth)."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, value in model.state_dict().items():
        value = value.detach().cpu()
        if value.dim() == 5:
            value = value[:, :, value.shape[2] // 2].clone()
        elif name.startswith("head."):
            value = torch.from_numpy(
                (0.02 * rng.normal(size=(1000, *value.shape[1:]))).astype(np.float32))
        elif name.endswith(("running_mean", "running_var")):
            value = torch.from_numpy(rng.uniform(0.5, 1.5, tuple(value.shape)).astype(np.float32))
        state[name] = value
    torch.save({"model": state}, path)
    return state


def phase_inflated_uniformer(card):
    """9e: UniFormer-S 16x4 from a seeded "in1k" image checkpoint
    (``write_image_checkpoint`` under ``M19_DIR/pretrained``) loaded through
    the registry (``utils/pretrain.py``: UNIFORMER.PRETRAIN_NAME
    uniformer_small_in1k, PMV_PRETRAIN_ROOT at that directory) on the card
    and on the CPU: every tensor equal bit for bit, the 2-D kernels inflated
    over T, the head and the BatchNorm statistics at their init; the f32
    eval at batch 1 card against CPU (atol 1e-4, 18 K1); then, a main path,
    2 bf16 batch-8 steps through ``train_epoch`` from the loaded weights
    (18 K1, 18 dx and 18 wgrad a step). Returns the train launches."""
    from pmv_tpu_torch.engine.steps import make_eval_step
    from pmv_tpu_torch.utils import pretrain

    root = os.path.join(M19_DIR, "pretrained")
    os.makedirs(root, exist_ok=True)
    cfg = uniformer_cfg()
    cfg.UNIFORMER.PRETRAIN_NAME = "uniformer_small_in1k"
    image_cfg = cfg.clone()
    image_cfg.MODEL.NUM_CLASSES = 1000
    saved = write_image_checkpoint(seeded_model(image_cfg, "cpu", torch.float32),
                                   os.path.join(root, "uniformer_small_in1k.pth"), seed=1)
    previous = os.environ.get("PMV_PRETRAIN_ROOT")
    os.environ["PMV_PRETRAIN_ROOT"] = root
    try:
        models = {}
        for dtype in (torch.float32, None):  # None: the config's bfloat16
            for device in ("cpu", "cuda") if dtype else ("cuda",):
                model = seeded_model(cfg, device, dtype)
                t0 = time.perf_counter()
                pretrain.load_pretrained(cfg, model)
                models[device, dtype] = (model, time.perf_counter() - t0)
    finally:
        if previous is None:
            os.environ.pop("PMV_PRETRAIN_ROOT")
        else:
            os.environ["PMV_PRETRAIN_ROOT"] = previous
    (cpu_model, cpu_s), (gpu_model, gpu_s) = models["cpu", torch.float32], models[
        "cuda", torch.float32]
    init = seeded_model(cfg, "cpu", torch.float32).state_dict()
    got, want = gpu_model.state_dict(), cpu_model.state_dict()
    unequal = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
    params = dict(cpu_model.named_parameters())
    inflated = [k for k in params if saved[k].dim() == 4 and want[k].dim() == 5]
    wrong = [k for k in params if k not in inflated and not k.startswith("head.")
             and not torch.equal(want[k], saved[k])]
    wrong += [k for k in inflated if not torch.equal(
        want[k], saved[k].unsqueeze(2).repeat(1, 1, want[k].shape[2], 1, 1) / want[k].shape[2])]
    at_init = [k for k in want if k.startswith("head.") or k not in params]
    moved = [k for k in at_init if not torch.equal(want[k], init[k])]

    frames = np.random.default_rng(1).integers(0, 256, (1, 16, 224, 224, 3), np.uint8)
    before = _launch_counts()
    gpu = make_eval_step(cfg, gpu_model, device="cuda")(frames).cpu()
    launches = _launches_since(before)
    cpu = make_eval_step(cfg, cpu_model, device="cpu")(frames)
    rec = {"phase": "inflated_uniformer_load_and_eval", "card": card,
           "tensors": len(want), "parameters": len(params), "inflated": len(inflated),
           "unequal_card_vs_cpu": unequal, "not_as_the_file": wrong, "moved_from_init": moved,
           "kept_init": len(at_init), "load_s_card": gpu_s, "load_s_cpu": cpu_s,
           "eval_max_abs_err_vs_cpu": float((gpu - cpu).abs().max()), "eval_launches": launches}
    log(json.dumps(rec))
    if unequal or wrong or moved or not inflated:
        raise AssertionError(f"9e: the load is not the file's: {rec}")
    if launches != eval_launches(UNIFORMER_K1) or rec["eval_max_abs_err_vs_cpu"] > 1e-4:
        raise AssertionError(f"9e: the eval differs from the CPU's, or launched {launches}")
    return phase_train(card, cfg, UNIFORMER_K1, "inflated_uniformer_",
                       model=models["cuda", None][0])


def kernels_line(records, launches, slowfast_launches, maskfeat_launches,
                 contrastive_launches, multigrid_launches, csn_launches, avslowfast_launches,
                 ava_launches, sp_launches, ssl_fsdp_launches, m19_launches):
    """One entry per kernel: times summed over the launches at the 224^2
    crop's shapes in bfloat16 at batch 8; K1 over one MViTv2-S forward (17
    launches, as many again for dx in a train step), the wgrad kernel over
    one train step (17 launches); "rect_ms" and "portrait_ms" the same at
    the PMV rect crop's grids and at their transposes; "uniformer" the same
    sums over UniFormer-S's 18 DPE launches, "x3d" over X3D-M's 22
    channelwise convs (kernel_ms the wrapper's, the channel pad included,
    and pad_ms the pad's alone; bound_ms on the unpadded shapes; for the
    wgrad kernel also the pad copies of a train step's layers through the
    autograd Function, step_pad_ms).
    ``launches`` sums every path's; "launches_slowfast" the SlowFast paths'
    (0: none of its convs is on K1), "launches_maskfeat" the MaskFeat paths'
    (phases 5m-7m and VIS_MASK); "maskfeat" the sums over one MaskFeat PT
    forward's 14 launches at batch 8, bf16 (``maskfeat_kernel_ms``; for K1
    the forward's, which dx repeats); "launches_contrastive" the contrastive
    paths' (phases 5c-6c, 0: Slow R50 has no K1 conv), the SimCLR step on
    X3D-M's backbone (phase 3cx) and the 2-rank SSL steps (phase 8d);
    "launches_multigrid" the multigrid paths' (phases 4g and 6g, 0: SlowFast
    has no K1 conv); "launches_csn" the CSN paths' (phases 4n-6n: 30 K1 a
    forward, 30 wgrad a train step), and "csn" the sums over ir-CSN-101's
    30 launches at batch 8 on 32 x 224^2, per dtype, over the same 30 on
    its 256^2 test crop ("test", per dtype; K1's forward, which the wgrad
    kernel never sees at that crop but is held there all the same), and
    over its 22 launches at [8, 8, 14, 14, 256] alone ("s4_22_launches",
    bf16); "launches_avslowfast" the AVSlowFast paths' (phases 4v-6v, 0: its
    convs are dense or 2-D); "launches_ava" the AVA detection paths'
    (phases 4a-6a, 0: SlowFast's and Slow's convs are dense);
    "launches_dp_sp" MViT's dp_sp paths' (phase 8e, both ranks),
    "launches_dp_sp_uniformer" UniFormer's (18 K1 a forward, 18 wgrad a
    step), "launches_dp_sp_conv" each conv family's (X3D-M 22, ir-CSN-101
    30, the others 0), and "dp_sp" the sums over a rank's 17 launches under
    dp_sp (4 + 2 halo planes of the 8), bf16, per grid: the rect crop's and
    its transposes at batch 2 (8e's train step) and 4 (8e's run_net), and
    the 224^2 crop's at batch 8; then over UniFormer's 18 ("uniformer_*":
    the rect crop's and its transposes at batch 2 and 4, the 224^2 test
    crop's at batch 4), X3D-M's 22 ("x3d_*": 8 + 2 of its 16 frames, the
    rect crop's and its transposes at batch 2 and 4, the 256^2 test crop's
    at batch 4) and ir-CSN-101's 30 ("csn_b2": 16, 8, 4 and 2 planes of its
    stages and 2 halo planes, 224^2, batch 2); "launches_ssl_fsdp" the SSL steps' under fsdp (phase 8f:
    MoCo 0, MaskFeat 14 a forward)."""
    maskfeat = maskfeat_kernel_ms(records)

    def entry(name, source, replaces, recs, basis):
        def grid(name):
            return [r for r in recs if r["dtype"] == "bfloat16" and r["grid"] == name]

        main = grid("square")

        def summed(key, rows=main):
            return sum(r[key] * r["launches_per_forward"] for r in rows)

        kernel_ms = summed("kernel_ms")
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "launches_slowfast": slowfast_launches[name],
            "launches_avslowfast": avslowfast_launches[name],
            "launches_ava": ava_launches[name],
            "launches_dp_sp": sp_launches["mvit"][name],
            "launches_dp_sp_uniformer": sp_launches["uniformer"][name],
            "launches_dp_sp_conv": {recipe: launches[name] for recipe, launches
                                    in sp_launches.items()
                                    if recipe not in ("mvit", "uniformer")},
            "launches_ssl_fsdp": ssl_fsdp_launches[name],
            "launches_maskfeat": maskfeat_launches[name],
            "launches_contrastive": {k: v[name] for k, v in contrastive_launches.items()},
            "launches_multigrid": multigrid_launches[name],
            "launches_visualization": {k: v[name] for k, v in m19_launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": kernel_ms,
            "kernel_ms": kernel_ms,
            "kernel_warm_ms": summed("kernel_warm_ms"),
            "plain_ms": summed("plain_ms"),
            "bound_ms": summed("bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main) else "operations",
            "library_ms": summed("library_ms"),
            "ms_basis": basis,
            # The same sums at the PMV rect crop's grids and their transposes.
            "rect_ms": summed("kernel_ms", grid("rect")),
            "rect_bound_ms": summed("bound_ms", grid("rect")),
            "portrait_ms": summed("kernel_ms", grid("portrait")),
            "portrait_bound_ms": summed("bound_ms", grid("portrait")),
            # A rank's shapes under dp_sp.
            "dp_sp": {
                g: {key: summed(key, grid("sp_" + g)) for key in (
                    "kernel_ms", "kernel_warm_ms", "plain_ms", "bound_ms", "library_ms")}
                for g in ("rect_b2", "portrait_b2", "rect_b4", "portrait_b4", "square_b8",
                          "uniformer_rect_b2", "uniformer_portrait_b2", "uniformer_rect_b4",
                          "uniformer_portrait_b4", "uniformer_square_b4",
                          "x3d_rect_b2", "x3d_portrait_b2", "x3d_rect_b4", "x3d_portrait_b4",
                          "x3d_square_b4", "csn_b2")
            },
            # The rect grids at run_net's train batch of 16.
            "rect_b16_ms": summed("kernel_ms", grid("rect_b16")),
            "rect_b16_bound_ms": summed("bound_ms", grid("rect_b16")),
            # UniFormer-S's DPE shapes: per grid set, each key summed.
            "uniformer": {
                g: {key: summed(key, grid("uni_" + g)) for key in (
                    "kernel_ms", "kernel_warm_ms", "plain_ms", "bound_ms", "library_ms")}
                for g in ("square", "rect", "portrait", "square_b16", "rect_b16",
                          "portrait_b16")
            },
            "x3d": {
                g: {key: summed(key, grid("x3d_" + g)) for key in (
                    "kernel_ms", "kernel_warm_ms", "pad_ms", "plain_ms", "bound_ms",
                    "library_ms", "step_pad_ms", "step_pad_ms_padded_per_call",
                ) if key in recs[0]}
                for g in ("square", "rect", "portrait", "test")
            },
            "maskfeat": maskfeat[name],
            "launches_csn": csn_launches[name],
            "csn": {
                **{dtype: {key: summed(key, [r for r in recs if r["grid"] == "csn"
                                             and r["dtype"] == dtype])
                           for key in ("kernel_ms", "kernel_warm_ms", "plain_ms", "bound_ms",
                                       "library_ms")}
                   for dtype in ("bfloat16", "float32")},
                "test": {dtype: {key: summed(key, [r for r in recs if r["grid"] == "csn_test"
                                                   and r["dtype"] == dtype])
                                 for key in ("kernel_ms", "kernel_warm_ms", "plain_ms",
                                             "bound_ms", "library_ms")}
                         for dtype in ("bfloat16", "float32")},
                "s4_22_launches": {key: summed(key, [
                    r for r in grid("csn") if tuple(r["shape"]) == (8, 8, 14, 14, 256)])
                    for key in ("kernel_ms", "kernel_warm_ms", "plain_ms", "bound_ms",
                                "library_ms")},
            },
        }

    fwd = [r for r in records if r["kernel"] == "depthwise3x3x3"]
    bwd = [r for r in records if r["kernel"] == "depthwise3x3x3_wgrad"]
    return {"kernels": [
        entry("depthwise3x3x3", "pmv_tpu_torch/ops/csrc/depthwise3x3x3.cu",
              "pmv_tpu/ops/depthwise_pallas.py:77", fwd,
              "17 launches: one batch-8 bf16 forward"),
        entry("depthwise3x3x3_wgrad", "pmv_tpu_torch/ops/csrc/depthwise3x3x3_wgrad.cu",
              "pmv_tpu/ops/depthwise_pallas.py:134", bwd,
              "17 launches: one batch-8 bf16 train step"),
    ]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every record to this JSON file")
    parser.add_argument("--plant-wrapper-faults", action="store_true",
                        help="only build the kernels and log phase 8b's readings with "
                        "faults planted in the wrappers (WRAPPER_FAULTS)")
    parser.add_argument("--run-net-counts", metavar="COUNTS",
                        help="only run run_net with the arguments after --, writing each "
                        "process's kernel launches beside COUNTS (phase 8c's processes)")
    parser.add_argument("run_net_argv", nargs="*", help=argparse.SUPPRESS)
    args = parser.parse_args()

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.run_net_counts:
        return run_net_counted(args.run_net_counts, args.run_net_argv)
    from pmv_tpu_torch.ops import build as kernel_build
    from pmv_tpu_torch.tools.timing import card_line

    float32_without_tf32()
    torch.set_num_threads(os.cpu_count() or 1)

    # Phase 1: the card, and the kernel build.
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    build_s = kernel_build.build_kernels()
    log(json.dumps({"phase": "build", "seconds": build_s}))
    for stem, output in kernel_build.build_log.items():
        log(f"nvcc {stem}.cu:\n{output.strip()}")
    spills = [line.strip() for output in kernel_build.build_log.values()
              for line in output.splitlines()
              if any(int(n) for n in re.findall(r"(\d+) bytes spill", line))]
    if spills:
        raise AssertionError("ptxas reports spills:\n" + "\n".join(spills))
    if args.plant_wrapper_faults:
        plant_wrapper_faults(card)
        log(card)
        return 0

    # Phase 2: every kernel against its plain version.
    walls = {"build": time.perf_counter() - t_start}
    tic = time.perf_counter()
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    records = phase_kernels(flush) + phase_backward(flush)
    del flush
    walls["kernels"] = time.perf_counter() - tic

    # Phase 3: the full models on the card and on the CPU, eval and train,
    # landscape and portrait.
    from pmv_tpu_torch.entry import mvitv2_s_cfg

    tic = time.perf_counter()
    by_model = {}  # the supervised group's seconds, model by model
    frames = np.random.default_rng(1).integers(0, 256, (1, 16, 224, 224, 3), np.uint8)
    phase_full_model(mvitv2_s_cfg(), frames, MVIT_K1)
    phase_train_step_vs_cpu(_train_cfg(), MVIT_K1)
    phase_portrait_steps(_train_cfg(), MVIT_K1)
    by_model["mvit"] = time.perf_counter() - tic
    uni = uniformer_cfg()
    phase_full_model(uni, frames, UNIFORMER_K1, "uniformer_full_model_f32_b1")
    phase_train_step_vs_cpu(uni, UNIFORMER_K1, "uniformer_train_step_f32_b2_card_vs_cpu")
    phase_portrait_steps(uni, UNIFORMER_K1, "uniformer_")
    by_model["uniformer"] = time.perf_counter() - tic - sum(by_model.values())
    x3d = x3d_cfg()
    phase_full_model(x3d, frames, X3D_K1, "x3d_full_model_f32_b1")
    phase_train_step_vs_cpu(x3d, X3D_K1, "x3d_train_step_f32_b2_card_vs_cpu")
    phase_portrait_steps(x3d, X3D_K1, "x3d_")
    phase_precise_bn(x3d, X3D_K1, "x3d_")
    by_model["x3d"] = time.perf_counter() - tic - sum(by_model.values())
    slowfast = slowfast_cfg()
    frames_32 = np.random.default_rng(1).integers(0, 256, (1, 32, 224, 224, 3), np.uint8)
    phase_full_model(slowfast, frames_32, SLOWFAST_K1, "slowfast_full_model_f32_b1")
    phase_train_step_vs_cpu(slowfast, SLOWFAST_K1, "slowfast_train_step_f32_b2_card_vs_cpu")
    phase_portrait_steps(slowfast, SLOWFAST_K1, "slowfast_")
    phase_precise_bn(slowfast, SLOWFAST_K1, "slowfast_")
    walls["card_vs_cpu_supervised"] = time.perf_counter() - tic
    by_model["slowfast"] = walls["card_vs_cpu_supervised"] - sum(by_model.values())
    walls["card_vs_cpu_supervised_by_model"] = by_model
    tic = time.perf_counter()
    phase_avslowfast_card_vs_cpu()
    walls["card_vs_cpu_avslowfast"] = time.perf_counter() - tic
    tic = time.perf_counter()
    phase_ava_card_vs_cpu()
    walls["card_vs_cpu_ava"] = time.perf_counter() - tic
    tic = time.perf_counter()
    phase_csn_card_vs_cpu()
    walls["card_vs_cpu_csn_r2plus1d_imagenet"] = time.perf_counter() - tic
    tic = time.perf_counter()
    phase_sub_batchnorm_card_vs_cpu()
    walls["card_vs_cpu_sub_batchnorm"] = time.perf_counter() - tic
    tic = time.perf_counter()
    phase_maskfeat_card_vs_cpu()
    t_3m = time.perf_counter() - tic
    phase_contrastive_card_vs_cpu()
    t_3c = time.perf_counter() - tic - t_3m
    x3d_ssl_launches = phase_contrastive_x3d()
    walls["card_vs_cpu_ssl"] = time.perf_counter() - tic
    walls["card_vs_cpu_ssl_by_phase"] = {"3m": t_3m, "3c": t_3c,
                                         "3cx": walls["card_vs_cpu_ssl"] - t_3m - t_3c}
    tic = time.perf_counter()

    # Phases 4 to 7: the main paths; serving, training, and run_net's train,
    # checkpoint, eval and test, then its resume; MViTv2-S, UniFormer-S,
    # then X3D-M.
    serve_mvit = mvitv2_s_cfg()
    serve_mvit.TEST.NUM_ENSEMBLE_VIEWS = 2
    serve_mvit.TEST.NUM_SPATIAL_CROPS = 3
    paths = [phase_serve(card, serve_mvit, MVIT_K1), phase_train(card, _train_cfg(), MVIT_K1)]
    out_dir = os.path.join("build", "chip_smoke_run_net")
    shutil.rmtree(out_dir, ignore_errors=True)
    with synthetic_videos(EARLIER_RUN_NET_VIDEOS):
        paths += phase_run_net(card, "mvit", out_dir)
    paths += [phase_serve(card, uni, UNIFORMER_K1, "uniformer_"),
              phase_train(card, uni, UNIFORMER_K1, "uniformer_")]
    out_dir = os.path.join("build", "chip_smoke_run_net_uniformer")
    shutil.rmtree(out_dir, ignore_errors=True)
    with synthetic_videos(EARLIER_RUN_NET_VIDEOS):
        paths += phase_run_net(card, "uniformer", out_dir)
    paths += [phase_serve(card, x3d, X3D_K1, "x3d_"), phase_train(card, x3d, X3D_K1, "x3d_")]
    out_dir = os.path.join("build", "chip_smoke_run_net_x3d")
    shutil.rmtree(out_dir, ignore_errors=True)
    with synthetic_videos(EARLIER_RUN_NET_VIDEOS):
        paths += phase_run_net(card, "x3d", out_dir)
    slowfast_paths = [phase_serve(card, slowfast, SLOWFAST_K1, "slowfast_"),
                      phase_train(card, slowfast, SLOWFAST_K1, "slowfast_")]
    out_dir = os.path.join("build", "chip_smoke_run_net_slowfast")
    shutil.rmtree(out_dir, ignore_errors=True)
    with synthetic_videos(EARLIER_RUN_NET_VIDEOS):
        slowfast_paths += phase_run_net(card, "slowfast", out_dir)
    paths += slowfast_paths
    walls["main_paths_supervised"] = time.perf_counter() - tic
    tic = time.perf_counter()
    avslowfast = avslowfast_cfg()
    avslowfast_paths = [phase_serve(card, avslowfast, AVSLOWFAST_K1, "avslowfast_"),
                        phase_train(card, avslowfast, AVSLOWFAST_K1, "avslowfast_", timed=3,
                                    profile=True)]
    out_dir = os.path.join("build", "chip_smoke_run_net_avslowfast")
    shutil.rmtree(out_dir, ignore_errors=True)
    register_synthetic_av()
    with synthetic_videos(EARLIER_RUN_NET_VIDEOS):
        avslowfast_paths += phase_run_net(card, "avslowfast", out_dir)
    paths += avslowfast_paths
    walls["main_paths_avslowfast"] = time.perf_counter() - tic
    tic = time.perf_counter()
    ava_paths = [phase_ava_serve(card),
                 phase_train(card, ava_cfg(), AVA_K1, "ava_", timed=3, profile=True)]
    out_dir = os.path.join("build", "chip_smoke_ava")
    shutil.rmtree(out_dir, ignore_errors=True)
    ava_paths += phase_ava_run_net(card, out_dir)
    paths += ava_paths
    walls["main_paths_ava"] = time.perf_counter() - tic
    tic = time.perf_counter()
    csn, r2plus1d = csn_cfg(), csn_cfg(R2PLUS1D_CFG)
    csn_paths = [phase_serve(card, csn, CSN_K1, "csn_"),
                 phase_train(card, csn, CSN_K1, "csn_", timed=3, profile=True)]
    out_dir = os.path.join("build", "chip_smoke_run_net_csn")
    shutil.rmtree(out_dir, ignore_errors=True)
    csn_paths += phase_run_net(card, "csn", out_dir)
    paths += csn_paths
    paths += [phase_serve(card, r2plus1d, R2PLUS1D_K1, "r2plus1d_"),
              phase_train(card, r2plus1d, R2PLUS1D_K1, "r2plus1d_", timed=3, profile=True)]
    out_dir = os.path.join("build", "chip_smoke_run_net_r2plus1d")
    shutil.rmtree(out_dir, ignore_errors=True)
    paths += phase_run_net(card, "r2plus1d", out_dir, resume=False)
    out_dir = os.path.join("build", "chip_smoke_charades")
    shutil.rmtree(out_dir, ignore_errors=True)
    paths.append(phase_charades(card, out_dir))
    walls["main_paths_csn_r2plus1d_charades"] = time.perf_counter() - tic
    tic = time.perf_counter()
    multigrid_paths = [phase_multigrid_shapes(card)]
    dirs = [os.path.join("build", f"chip_smoke_{d}") for d in (
        "run_net_multigrid", "run_net_multigrid_resumed", "profile", "benchmark")]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    with synthetic_videos(MULTIGRID_VIDEOS):
        multigrid_paths += phase_multigrid_run_net(card, *dirs[:3])
    paths += multigrid_paths
    phase_data_benchmark(dirs[3])
    walls["main_paths_multigrid"] = time.perf_counter() - tic
    tic = time.perf_counter()
    phase_maskfeat_step(card, records)
    maskfeat_paths = [phase_maskfeat_train(card)]
    out_dir = os.path.join("build", "chip_smoke_run_net_maskfeat")
    shutil.rmtree(out_dir, ignore_errors=True)
    with synthetic_videos(EARLIER_RUN_NET_VIDEOS):
        pt_paths, pt_checkpoint = phase_maskfeat_run_net(card, out_dir)
        maskfeat_paths += pt_paths
        out_dir = os.path.join("build", "chip_smoke_run_net_maskfeat_ft")
        shutil.rmtree(out_dir, ignore_errors=True)
        maskfeat_paths.append(phase_maskfeat_fine_tune(card, pt_checkpoint, out_dir))
    out_dir = os.path.join("build", "chip_smoke_vis_mask")
    shutil.rmtree(out_dir, ignore_errors=True)
    maskfeat_paths.append(phase_maskfeat_vis_mask(card, out_dir))
    paths += maskfeat_paths
    phase_contrastive_step(card)
    out_dir = os.path.join("build", "chip_smoke_run_net_moco")
    ft_dir = os.path.join("build", "chip_smoke_run_net_slow_ft")
    for d in (out_dir, ft_dir):
        shutil.rmtree(d, ignore_errors=True)
    contrastive_paths = [phase_contrastive_train(card)]
    with synthetic_videos(EARLIER_RUN_NET_VIDEOS):
        contrastive_paths += phase_contrastive_run_net(card, out_dir, ft_dir)
    paths += contrastive_paths
    walls["main_paths_ssl"] = time.perf_counter() - tic

    # Phase 8: the distributed paths.
    from concurrent.futures import ThreadPoolExecutor

    log(json.dumps({"phase": "imports", **{m: imports(m) for m in (
        "torch.utils.tensorboard", "matplotlib", "cv2", "moviepy")}}))
    def timed(name, fn, *args):
        tic = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - tic
        return out

    paths += [timed("distributed_8a", phase_distributed_gloo)]
    paths += timed("distributed_8b", phase_distributed_nccl, card)
    ssl_fsdp_paths = timed("ssl_fsdp_8f", phase_ssl_fsdp_nccl, card)
    paths += ssl_fsdp_paths
    sp_ranks = timed("sequence_parallel_8e", phase_sequence_parallel, card)
    # The run_net pairs' processes (8e's and 8c's) spend most of their time
    # starting (two interpreters a host, gloo, CUDA): they start together,
    # and 8d's ranks run beside them from a thread. 8a, 8b, 8f and 8e's
    # spawn, which time their steps, run alone.
    torch.cuda.empty_cache()
    with ThreadPoolExecutor(1) as pool:
        ssl_8d = pool.submit(timed, "distributed_8d", phase_distributed_ssl)
        run_net_8c, sp_run_nets = timed("run_net_pairs_8c_8e", phase_run_net_pairs, card)
        ssl_dist_launches = ssl_8d.result()
    paths += run_net_8c
    sp_paths = {recipe: [launches] + sp_run_nets.get(recipe, [])
                for recipe, launches in sp_ranks.items()}
    paths += [p for recipe_paths in sp_paths.values() for p in recipe_paths]

    # Phases 9a-9e: Grad-CAM, the visualization through run_net, the demos,
    # the inflated UniFormer-S.
    checkpoint = mvit_run_net_checkpoint()
    m19_launches = {
        "gradcam_card_vs_cpu": timed("gradcam_9a", phase_gradcam, card, checkpoint),
        "run_net_visualization": timed("visualization_9b", phase_visualization_run_net, card,
                                       checkpoint),
        "demo": timed("demo_9c", phase_demo, card),
        "ava_demo": timed("ava_demo_9d", phase_ava_demo, card),
        "inflated_uniformer_train": timed("inflated_uniformer_9e", phase_inflated_uniformer, card),
    }
    paths += [v for k, v in m19_launches.items() if k != "gradcam_card_vs_cpu"]
    launches = {k: sum(p[k] for p in paths) for k in paths[0]}
    slowfast_launches = {k: sum(p[k] for p in slowfast_paths) for k in paths[0]}
    avslowfast_launches = {k: sum(p[k] for p in avslowfast_paths) for k in paths[0]}
    ava_launches = {k: sum(p[k] for p in ava_paths) for k in paths[0]}
    sp_launches = {recipe: {k: sum(p[k] for p in recipe_paths) for k in paths[0]}
                   for recipe, recipe_paths in sp_paths.items()}
    ssl_fsdp_launches = {k: sum(p[k] for p in ssl_fsdp_paths) for k in paths[0]}
    maskfeat_launches = {k: sum(p[k] for p in maskfeat_paths) for k in paths[0]}
    multigrid_launches = {k: sum(p[k] for p in multigrid_paths) for k in paths[0]}
    csn_launches = {k: sum(p[k] for p in csn_paths) for k in paths[0]}
    contrastive_launches = {
        "main_paths": {k: sum(p[k] for p in contrastive_paths) for k in paths[0]},
        "x3d_simclr_step": x3d_ssl_launches, "distributed_ssl_ranks": ssl_dist_launches}

    log(json.dumps({"phase": "walls", "seconds": walls}))
    log(json.dumps({"phase": "total", "wall_s": time.perf_counter() - t_start}))
    line = kernels_line(records, launches, slowfast_launches, maskfeat_launches,
                        contrastive_launches, multigrid_launches, csn_launches,
                        avslowfast_launches, ava_launches, sp_launches, ssl_fsdp_launches,
                        m19_launches)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "records": records, **line}, f, indent=1)
    log(json.dumps(line))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
