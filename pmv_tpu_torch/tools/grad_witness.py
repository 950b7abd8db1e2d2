"""How close two float32 runs of one train step's gradients can be, and why.

One model (X3D-M by default) at its seeded random init, one batch, the
head's dropout mask drawn once: the train-mode forward, the loss
(MODEL.LOSS_FUNC, cross-entropy for X3D) and the backward, in float32 on
the card, in float32 on the CPU, and in float64 on the CPU (activations,
BatchNorm statistics, the plain depthwise convs and the loss in float64:
the reference). On the card twice: with TF32 off, as chip_smoke.py runs
its float32 gates, and with PyTorch's default, which lets cuDNN's convs
round their inputs to TF32. For each float32 run it prints the relative
L2 distance of every parameter's gradient from the float64 run's, the
grad norms and the BatchNorm running statistics (their largest difference
beyond rtol 1e-4): first as the run decides each ReLU itself, then with
every ReLU taking the float64 run's decisions (``relu_decisions``), with
the count of decisions the run's own inputs would have taken otherwise. A ReLU
whose input lies within a rounding of 0 decides either way, and its one
element's gradient moves the whole gradient; with the decisions held
equal, what is left is the float32 rounding itself.

    python -m pmv_tpu_torch.tools.grad_witness [--cfg configs/Kinetics/X3D_M.yaml]
        [--batch 2] [--frames F] [--crop S] [--cpu-only] [--out FILE]

AVSlowFast's yaml runs with seeded log-mel audio and misaligned audio, its
AVS losses in the loss. A detection yaml (configs/AVA/, DETECTION.ENABLE)
runs on 16 box slots a clip, 3 of them valid (one at the crop's edge),
with multi-hot labels and the detection step's loss
(``steps.detection_loss``).

Without ``--cpu-only`` it needs a CUDA device. The full-size X3D-M step in
float64 on the CPU takes some GiB and a minute or so: run it on the GPU
machine, or at a small ``--frames`` and ``--crop``.
"""

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

X3D_M = "configs/Kinetics/X3D_M.yaml"
# The float32 train step's limit, card against CPU, each deciding its own
# ReLUs, of a model whose ReLUs make its gradients jump: the relative L2 of
# the gradients. Set between the sound readings and the faults' of
# tests/test_torch_port_x3d_gradients.py (PERF.md section 6): at full width
# and depth on a small input, X3D-M's float32 gradients, the port's and the
# JAX package's, lie up to 3.1e-2 from float64 ones; a fault in K1's taps,
# its channel pad's slice, dx's weight flip or BatchNorm's eps moves them by
# 0.91 or more. The grad norm of such a step is not held: a sound reading
# of the JAX package's own moves it by 5.5e-3, as far as some faults do.
# With the ReLU decisions held equal, the gradients and the grad norm are
# held to 1e-4. SlowFast 8x8 R50's float32 gradients jump the same way: the
# card's lie 2.4e-2 to 2.6e-2 from the CPU's, and the CPU's 1.8e-2 from
# float64 ones (at 8 frames of 64^2); so they take X3D's limit.
# Slow R50 (the contrastive yamls' backbone, configs/contrastive_ssl/) has
# SlowFast's slow pathway's ReLUs, and takes its limit and its float64 check:
# the MoCo yaml's float32 step at batch 2, card against CPU, reads 1.33e-2,
# and 1.69e-4 with the CPU's ReLU decisions held (PERF.md section 6).
# ir-CSN-101's (configs/Kinetics/CSN_32x2_R101.yaml) float32 gradients jump
# further: at batch 1 on 16 frames of 224^2 the card's lie 5.5e-2 from
# float64 ones, the CPU's 7.6e-2, card and CPU 7.9e-2 apart (an NVIDIA H100
# 80GB HBM3 at 700 W and its host's CPU), so its limit is 0.2, still under
# a fifth of X3D's faults'. R(2+1)D-50 takes X3D's limit, and SlowFast's
# float64 check.
# AVSlowFast, whose visual trunk is SlowFast's, takes SlowFast's limit and
# its float64 check; so do SlowFast and Slow with AVA's RoI head
# (DETECTION.ENABLE, "SlowFast_AVA" and "Slow_AVA"), whose max over the
# RoIAlign bins adds near-ties that move float32 gradients as a ReLU does.
# SlowFast 32x2 AVA at batch 2 on 8 frames of 224^2 (``--cfg
# configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml --batch 2 --frames 8``, an NVIDIA
# H100 80GB HBM3 at 700 W and its host's CPU): float32 gradients 2.05e-2
# (CPU) and 2.11e-2 (card) from float64 ones free, 2.8e-5 with float64's
# ReLU decisions held; its statistics 3.0e-7 and 3.5e-7 beyond rtol 1e-4,
# under the 1e-6 gate, so it takes no entry in STATS_LIMITS.
RELU_LIMITS = {"X3D": 0.1, "SlowFast": 0.1, "Slow": 0.1, "CSN": 0.2, "R2Plus1D": 0.1,
               "AVSlowFast": 0.1, "SlowFast_AVA": 0.1, "Slow_AVA": 0.1}
# Models whose float32 step cannot meet the 1e-4 gates even with the ReLU
# decisions held: SlowFast's float32 gradients lie 9.9e-5 from float64 ones
# on the CPU with float64's decisions held (8 frames of 64^2), the card's
# 3.8e-4 from the CPU's with the CPU's decisions held (full size), and its
# float32 BatchNorm statistics of the last stage (batch means of 1e-3)
# 2.7e-6 over the statistics' gate on the CPU against float64. Their held
# check is the step (and precise BN) in float64 on card and CPU, at 1e-4.
FLOAT64_HELD = {"SlowFast", "Slow", "R2Plus1D", "AVSlowFast", "SlowFast_AVA", "Slow_AVA"}
# Models whose float32 floor with the ReLU decisions held lies above 1e-4,
# and whose check stays in float32 (CSN's depthwise convs run on K1, which
# takes no float64): the gradients' and the grad norm's limit, card against
# CPU with the CPU's decisions held, a stated margin over the floor
# measured against float64. ir-CSN-101 at batch 1 on 16 frames of 224^2:
# the CPU's float32 gradients lie 4.75e-4 from float64 ones with float64's
# decisions held, the card's 4.90e-4, card and CPU 5.67e-4 apart (the same
# in every layer: the rounding of the last stage's BatchNorm backward,
# carried down); margin 3.
HELD_LIMITS = {"CSN": 3 * 4.75e-4}
# The same for the BatchNorm running statistics of a float32 step, read as
# their largest difference beyond rtol 1e-4 (1e-6 elsewhere). At batch 1 on
# 16 frames the last stage's statistics are means over 2 x 7 x 7 positions,
# and float32 moves them further: ir-CSN-101's lie 1.44e-5 (CPU) and 1.68e-5
# (card, float64's ReLU decisions held) beyond it from float64 ones,
# R(2+1)D-50's 3.75e-6 and 4.29e-6 (s5's shortcut and last BatchNorms);
# margin 3. R(2+1)D's float64 step holds them to 1e-6. AVSlowFast 8x8 R50 at
# batch 1 on 8 frames of 224^2 and a 128 x 80 log-mel: its last audio
# junction's statistics (s5_fuse.bn_a2fs_1, 4 values a channel) lie 4.34e-6
# (CPU) and 3.39e-6 (card) beyond it from float64 ones, card and CPU 6.0e-6
# apart (``--cfg configs/Kinetics/AVSLOWFAST_8x8_R50.yaml --batch 1 --frames
# 8``, an NVIDIA H100 80GB HBM3 at 700 W); margin 3; its float64 step holds
# them to 1e-6.
STATS_LIMITS = {"CSN": 3 * 1.68e-5, "R2Plus1D": 3 * 4.29e-6, "AVSlowFast": 3 * 4.34e-6}


def witness_key(cfg):
    """The key of ``cfg``'s net in ``RELU_LIMITS``, ``FLOAT64_HELD``,
    ``HELD_LIMITS`` and ``STATS_LIMITS``: its MODEL_NAME (CSN for PTVCSN,
    R2Plus1D for PTVR2plus1D), or for a ResNet and a contrastive model its
    backbone's (X3D for arch x3d, Slow for arch slow); "_AVA" after it with
    DETECTION.ENABLE."""
    suffix = "_AVA" if cfg.DETECTION.ENABLE else ""
    if cfg.MODEL.MODEL_NAME in ("ResNet", "ContrastiveModel"):
        return {"x3d": "X3D", "slow": "Slow"}.get(cfg.MODEL.ARCH, cfg.MODEL.MODEL_NAME) + suffix
    return {"PTVCSN": "CSN", "PTVR2plus1D": "R2Plus1D"}.get(cfg.MODEL.MODEL_NAME,
                                                           cfg.MODEL.MODEL_NAME) + suffix


@dataclasses.dataclass
class Decisions:
    """The decisions of each call, in call order (a ReLU's input > 0, a max
    pool's tap), and the count of elements whose input would have decided
    otherwise."""

    masks: list
    taken_otherwise: int = 0


@contextlib.contextmanager
def relu_decisions(decisions=None):
    """Within the block, ``F.relu`` records each call's decisions into the
    yielded ``Decisions``; or, given ``decisions`` (a record of a run of the
    same model on the same batch), applies them in call order:
    relu(v) = v * decision, whose gradient is that of a ReLU that decided
    so, and counts the elements whose own sign differs."""
    record = Decisions([])
    relu = F.relu

    def recorded_relu(v, inplace=False):
        mine = v.detach() > 0
        if decisions is None:
            record.masks.append(mine)
            return relu(v)
        mask = decisions.masks[len(record.masks)].to(v.device)
        record.masks.append(mask)
        record.taken_otherwise += int((mask != mine).sum())
        return v * mask

    F.relu = recorded_relu
    try:
        yield record
    finally:
        F.relu = relu


@contextlib.contextmanager
def max_pool_decisions(decisions=None):
    """Within the block, ``F.max_pool3d`` records each call's decisions (the
    tap each output takes, as its indices) into the yielded ``Decisions``;
    or, given ``decisions`` (a record of a run of the same model on the same
    batch), takes those taps in call order, out = x at the recorded tap,
    whose gradient goes to that tap, and counts the outputs whose own
    maximum lies at another. Two taps within a rounding of each other decide
    either way, and the whole gradient moves with the one element's."""
    record = Decisions([])
    pool = F.max_pool3d

    def recorded_pool(x, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False,
                      return_indices=False):
        out, index = pool(x, kernel_size, stride, padding, dilation, ceil_mode,
                          return_indices=True)
        if decisions is not None:
            held = decisions.masks[len(record.masks)].to(x.device)
            record.taken_otherwise += int((held != index).sum())
            index = held
            out = x.flatten(2).gather(2, index.flatten(2)).view_as(out)
        record.masks.append(index)
        return (out, index) if return_indices else out

    F.max_pool3d = recorded_pool
    try:
        yield record
    finally:
        F.max_pool3d = pool


def load_cfg(path, opts=()):
    from pmv_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(path)
    cfg.merge_from_list(list(opts))
    return cfg


def detection_boxes(size, crop, classes, rng, slots=16, valid=3):
    """A detection batch's "boxes" [size, slots, 4] in the crop's pixels,
    "box_mask" [size, slots] (the first ``valid`` of each clip, the first
    reaching the crop's bottom-right edge) and multi-hot "labels" [size,
    slots, classes] (0 on padded slots), from ``rng``."""
    boxes = np.zeros((size, slots, 4), np.float32)
    xy = rng.uniform(0, 0.6 * crop, (size, valid, 2))
    wh = rng.uniform(0.2 * crop, 0.4 * crop, (size, valid, 2))
    boxes[:, :valid] = np.concatenate([xy, np.minimum(xy + wh, crop - 1)], axis=-1)
    boxes[:, 0, 2:] = crop - 1
    mask = np.zeros((size, slots), bool)
    mask[:, :valid] = True
    labels = (rng.uniform(size=(size, slots, classes)) < 0.1) * mask[..., None]
    return {"boxes": boxes, "box_mask": mask, "labels": labels.astype(np.float32)}


def batch(cfg, size, seed=2):
    """uint8 frames [size, T, S, S, 3] at the train crop, labels, the head's
    dropout keep mask (None without head dropout), for AVSlowFast the
    log-mel audio and misaligned audio ([size, AUDIO_FRAME_NUM,
    AUDIO_MEL_NUM], normal draws: the loader's clips are z-normalised), and
    for a detection config ``detection_boxes`` (else {}), from ``seed``;
    a detection config's labels are its boxes' multi-hot rows."""
    from pmv_tpu_torch.models.build import MODEL_REGISTRY

    rng = np.random.default_rng(seed)
    s = cfg.DATA.TRAIN_CROP_SIZE
    frames = rng.integers(0, 256, (size, cfg.DATA.NUM_FRAMES, s, s, 3), np.uint8)
    labels = rng.integers(0, cfg.MODEL.NUM_CLASSES, size)
    det = {}
    if cfg.DETECTION.ENABLE:
        det = detection_boxes(size, s, cfg.MODEL.NUM_CLASSES, rng)
        labels = det.pop("labels")
    audio = ()
    if cfg.MODEL.ARCH == "avslowfast":
        shape = (size, cfg.DATA.AUDIO_FRAME_NUM, cfg.DATA.AUDIO_MEL_NUM)
        audio = tuple(rng.normal(size=shape).astype(np.float32) for _ in range(2))
    keep = 1.0 - cfg.MODEL.DROPOUT_RATE
    mask = None
    if keep < 1.0:
        with torch.device("meta"):  # the mask's shape, with no weights made
            model = MODEL_REGISTRY.get(cfg.MODEL.MODEL_NAME)(cfg)
        rows = size * det["boxes"].shape[1] if det else size  # a detection head's boxes
        shape = model.sample_head_dropout_mask(rows, None, "meta").shape
        mask = (rng.random(tuple(shape)) < keep).astype(np.float32)
    return frames, labels, mask, audio, det


def gradients(cfg, data, device, dtype, decisions=None):
    """One train-mode forward and backward of the seeded model in ``dtype``
    on ``device`` (AVSlowFast's with the misaligned audio, DropPathway
    keeping the audio, its AVS losses added to the loss): ({name: gradient,
    float64 on the CPU}, loss, Decisions, {name: BatchNorm running
    statistic after the forward, float64 on the CPU})."""
    from pmv_tpu_torch.engine.steps import detection_loss, make_eval_preprocess_fn, model_input
    from pmv_tpu_torch.models import build_model
    from pmv_tpu_torch.models.losses import get_loss_func

    frames, labels, mask, audio, det = data
    model = build_model(cfg, device=device, dtype=dtype, seed=0)
    model.train()
    x = model_input(cfg, make_eval_preprocess_fn(cfg, device=device)(
        torch.as_tensor(frames).to(device)), *(torch.as_tensor(a).to(device) for a in audio))
    kwargs = {k: torch.as_tensor(v).to(device) for k, v in det.items()}
    if mask is not None:
        kwargs["head_dropout_mask"] = torch.as_tensor(mask).to(device)
    with relu_decisions(decisions) as record:
        preds = model(x, **kwargs)
    aux = {}
    if isinstance(preds, tuple):  # AVSlowFast's AVS losses
        preds, aux = preds
    labels = torch.as_tensor(labels).to(device)
    if det:
        loss = detection_loss(preds, labels, kwargs["box_mask"])
    else:
        loss = get_loss_func(cfg.MODEL.LOSS_FUNC)(
            preds.to(torch.promote_types(dtype, torch.float32)), labels)
    for value in aux.values():
        loss = loss + value
    loss.backward()
    grads = {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}
    stats = {k: b.detach().double().cpu() for k, b in model.named_buffers() if "running" in k}
    return grads, float(loss.detach()), record, stats


def stats_distance(stats, ref):
    """BatchNorm running statistics against ``ref``: the largest difference
    beyond rtol 1e-4 (what chip_smoke.py gates at 1e-6), the largest
    difference, and the tensor of the first."""
    over = {k: float(((stats[k] - v).abs() - 1e-4 * v.abs()).max()) for k, v in ref.items()}
    worst = max(over, key=over.get, default=None)
    return {"over_rtol": over.get(worst, 0.0), "tensor": worst,
            "max_abs": max((float((stats[k] - v).abs().max()) for k, v in ref.items()),
                           default=0.0)}


def distance(grads, ref):
    """Relative L2 distance of all of ``grads`` from all of ``ref``."""
    diff = sum(float((grads[k] - v).square().sum()) for k, v in ref.items())
    return (diff / sum(float(v.square().sum()) for v in ref.values())) ** 0.5


def norm(grads):
    return sum(float(v.square().sum()) for v in grads.values()) ** 0.5


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cfg", default=X3D_M)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--frames", type=int, help="DATA.NUM_FRAMES (the config's by default)")
    parser.add_argument("--crop", type=int, help="DATA.TRAIN_CROP_SIZE (the config's by default)")
    parser.add_argument("--cpu-only", action="store_true", help="leave the card out")
    parser.add_argument("--out", help="also write the JSON line here")
    args = parser.parse_args(argv)
    if not args.cpu_only and not torch.cuda.is_available():
        print("grad_witness: no CUDA device (or --cpu-only)", file=sys.stderr)
        return 1
    opts = []
    if args.frames:
        opts += ["DATA.NUM_FRAMES", str(args.frames)]
    if args.crop:
        opts += ["DATA.TRAIN_CROP_SIZE", str(args.crop)]
    cfg = load_cfg(args.cfg, opts)
    data = batch(cfg, args.batch)
    t0 = time.perf_counter()
    ref, ref_loss, ref_decisions, ref_stats = gradients(cfg, data, "cpu", torch.float64)
    rec = {"model": cfg.MODEL.MODEL_NAME, "batch": args.batch,
           "frames": cfg.DATA.NUM_FRAMES, "crop": cfg.DATA.TRAIN_CROP_SIZE,
           "relu_elements": sum(int(m.numel()) for m in ref_decisions.masks),
           "f64_loss": ref_loss, "f64_grad_norm": norm(ref), "f64_s": time.perf_counter() - t0}
    if not args.cpu_only:
        from pmv_tpu_torch.tools.timing import card_line

        rec["card"] = card_line()
    runs = [("cpu", "cpu", False)]
    if not args.cpu_only:
        runs += [("cuda", "cuda", False), ("cuda_tf32", "cuda", True)]
    for name, device, tf32 in runs:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        for held in (False, True):
            grads, loss, record, stats = gradients(cfg, data, device, torch.float32,
                                                   ref_decisions if held else None)
            key = f"{name}_f32" + ("_f64_decisions" if held else "")
            rec[key] = {"grad_rel_l2_vs_f64": distance(grads, ref),
                        "grad_norm_rel_vs_f64": norm(grads) / rec["f64_grad_norm"] - 1,
                        "loss_rel_vs_f64": loss / ref_loss - 1,
                        "bn_stats_vs_f64": stats_distance(stats, ref_stats)}
            if held:
                rec[key]["decisions_taken_otherwise"] = record.taken_otherwise
            elif name == "cpu":
                cpu_grads, cpu_stats = grads, stats
            else:
                rec[key]["grad_rel_l2_vs_cpu_f32"] = distance(grads, cpu_grads)
                rec[key]["bn_stats_vs_cpu_f32"] = stats_distance(stats, cpu_stats)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
