"""Training (`MViT/tools/train_net.py:33-814`).

Counterpart of `pmv_tpu/engine/train.py`.

- ``train_epoch``: each iteration takes its LR from ``lr_policy`` at the
  fractional epoch ``cur_epoch + iter / len`` and runs the train step on a
  batch read through ``DevicePrefetcher`` (TPU.DEVICE_PREFETCH batches
  ahead on the card; none on the CPU). The step routes the batch's portrait
  rows itself (the JAX package picks its pm step per batch, `train.py:130`;
  on a batch without portrait rows the two are the same). The step's metrics stay on the device until a flush every
  LOG_PERIOD iterations (and at the end of the epoch), where the host reads
  them, runs the NaN guard and the loss-explosion guard, and feeds the
  TrainMeter. So up to LOG_PERIOD - 1 steps may run after a bad one before
  the guard raises, and the epoch-end flush raises before a checkpoint of
  poisoned weights is written.
- ``eval_epoch``: the validation loop into a ValMeter; with
  DETECTION.ENABLE ``eval_detection_epoch``, the detection eval step into
  an ``AVAMeter`` in "val" mode, whose mAP the epoch reports. The JAX
  package's ``eval_epoch`` cannot run detection (it calls the eval step
  without boxes, `pmv_tpu/engine/train.py:159`), nor can its ``train``
  start an AVA run (its example batch for the init holds no boxes,
  `:234-237`): the port's ``train`` builds the model from the config and
  its loops pass the boxes (ROADMAP.md records both differences).
- ``train``: seeds, model, its wrapper for the strategy in a
  multi-process job (``parallel/distributed.py``), optimizer, auto-resume,
  loaders, meters, the TensorBoard writer (rank 0), then per epoch
  {set_epoch, train_epoch, precise BN, checkpoint, eval_epoch}, then the
  result string.

In a multi-process job every rank runs ``train`` on its shard of each
split, from the same seeds and the same weights: the train step gives the
global batch's numbers (``engine/steps.py``), the meters count the global
batch (this rank's rows x the world size), the evaluation gathers every
rank's predictions, and rank 0 logs, writes the checkpoints and the
TensorBoard events. With TENSORBOARD.ENABLE the writer takes the
evaluation's errors after each evaluated epoch (Val/Top1_err, Val/Top5_err;
Val/mAP when multi-label), as the JAX package's ``train`` does
(`train.py:282-286, 372-382`).

- The profiler window (TPU.PROFILE_DIR, `pmv_tpu/engine/train.py:41-44,
  125-143`): a ``torch.profiler`` trace (CPU activities, and CUDA's on the
  card) of steps 10 to 15 of epoch 0, or of steps 0 to min(2, n) in an
  epoch of n <= 15 steps, written to that directory by
  ``tensorboard_trace_handler``: one trace a job (rank 0's), ended cleanly
  when the epoch ends inside the window.
- Multigrid (MULTIGRID.LONG_CYCLE / SHORT_CYCLE; `pmv_tpu/engine/train.py:
  213-218, 304-356`, ``utils/multigrid.py``): ``init_multigrid`` rewrites
  the schedule before the model is built; at every epoch
  ``update_long_cycle`` sets the base shape, and where it changes the train
  loader and its TrainMeter are built anew, the model's norms turn to the
  BatchNorm type of the cycle's batch (``models/batchnorm.py::
  swap_norms``, in place: the parameters, the optimizer's state and a DDP
  or FSDP wrapper stay), and the steps are built anew. The val loader is
  built once; its dataset reads the cfg the cycles change. A resume sets
  the long cycle of the checkpoint's epoch before the checkpoint loads, so
  that its statistics fit, and the first epoch then moves to its own, as
  the run that wrote it did. ``is_eval_epoch`` takes the schedule.

It trains MViT, UniFormer, X3D, the ResNet family, CSN, R(2+1)D and
AVSlowFast, on Kinetics, Kinetics_av, Synthetic or the frame-list datasets
(SSv2, Sth, Charades, ImageNet), and AVA's detection on the ResNet family
(DETECTION.ENABLE: ``steps.make_detection_train_step`` on ``Ava``'s
keyframes, the val epoch's AVA mAP); with DATA.MULTI_LABEL (Charades) the loss is
MODEL.LOSS_FUNC's (``bce_logit``) on label vectors and the eval epoch
reports mAP (``utils/meters.py``). The BatchNorm running
statistics of a model that has them move in its train step and are saved
with its checkpoints. With BN.USE_PRECISE_STATS they are recomputed after every
epoch's training, before the checkpoint and the eval, as the JAX package
does (`train.py:352-366`; ``engine/precise_bn.py``).
MODEL.USE_CHECKPOINT and MODEL.CHECKPOINT_NUM (UniFormer's activation
checkpointing) are read nowhere in the JAX package, and are ignored here.

AVSlowFast's batches carry the log-mel "audio" and "audio_mis": the train
loop rolls "audio_mis" into the AVS easy negatives of the epoch
(``steps.easy_negatives``, the JAX package's ``prepare_batch``,
`train.py:96-109`), and the eval loop, the test loop and precise BN pass
the batch's "audio", which the JAX package's loops drop (its
``eval_step(state, frames, audio)`` takes it).

A Uniformer or Uniformerframe that starts at epoch 0 with no
TRAIN.CHECKPOINT_FILE_PATH loads UNIFORMER.PRETRAIN_NAME through the
pretrain registry (``utils/pretrain.py``: an image checkpoint inflated over
T, its head dropped where the class count differs), as the JAX package's
``train`` does (`train.py:246-258`).

Not run, each raising NotImplementedError where the config asks for it, as
the JAX package cannot run them either: precise BN with DETECTION.ENABLE
(the JAX package's ``precise_bn`` packs no boxes), and MULTIGRID.SHORT_CYCLE
on a frame-list dataset (its samples refuse the short cycle's (index, phase)
index, on which the JAX package's fail).
"""

import math
import pprint
import time

import numpy as np
import torch

from pmv_tpu_torch.data import loader as loader_mod
from pmv_tpu_torch.engine import steps
from pmv_tpu_torch.engine.precise_bn import calculate_and_update_precise_bn
from pmv_tpu_torch.engine.prefetch import DevicePrefetcher
from pmv_tpu_torch.models import build_model
from pmv_tpu_torch.models.batchnorm import norm_name, swap_norms
from pmv_tpu_torch.parallel import distributed, mesh
from pmv_tpu_torch.utils import checkpoint as cu
from pmv_tpu_torch.utils import logging as pmv_logging
from pmv_tpu_torch.utils import meters as meters_mod
from pmv_tpu_torch.utils import metrics as metrics_mod
from pmv_tpu_torch.utils import misc, pretrain
from pmv_tpu_torch.utils.device import rank_and_world_size, resolve_device
from pmv_tpu_torch.utils.lr_policy import get_lr_at_epoch
from pmv_tpu_torch.utils.multigrid import MultigridSchedule

logger = pmv_logging.get_logger(__name__)


def profiler_window(data_size):
    """The steps (first, last) of epoch 0 that TPU.PROFILE_DIR traces."""
    return (10, 15) if data_size > 15 else (0, min(2, data_size))


def start_profiler(prof_dir, device):
    """A started ``torch.profiler`` of the host's activities, and the card's
    on CUDA, that writes its trace to ``prof_dir`` when it stops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(prof_dir),
    )
    prof.start()
    return prof


def stop_profiler(prof, device, first, last, prof_dir):
    """Stop ``prof`` once the card has run what it was given; its trace is
    written."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    logger.info("Profiled steps %d to %d of epoch 0 into %s", first, last, prof_dir)


def train_epoch(train_loader, train_step, state, meter, cur_epoch, cfg):
    """One epoch over ``train_loader`` (any sized iterable of batches with
    "frames" and "labels", and "pm" where rows may be portrait, and "audio"
    and "audio_mis" for AVSlowFast; or "frames" and "mask" for the masked
    step of ``engine/ssl_steps.py``). Returns ``state``, updated in
    place."""
    data_size = len(train_loader)
    world = mesh.data_shard_count(cfg)  # the processes over which the rows are split
    pending = []
    flush_every = max(1, cfg.LOG_PERIOD)

    def flush_metrics():
        for it, lr_it, mb_size, m in pending:
            m = {k: v.item() for k, v in m.items()}  # waits for the device
            if m["nan"]:
                raise RuntimeError(f"ERROR: Got NaN losses at iter {it}")
            if (
                cfg.TRAIN.KILL_LOSS_EXPLOSION_FACTOR > 0.0
                and meter.loss.count > 10
                and m["loss"]
                > cfg.TRAIN.KILL_LOSS_EXPLOSION_FACTOR * meter.loss.get_global_avg()
            ):
                raise RuntimeError(f"ERROR: Got Loss explosion of {m['loss']}")
            # A masked (SSL) step has no top-k errors: 0, as the JAX
            # package's SSL loop logs them.
            meter.update_stats(
                m.get("top1_err", 0.0), m.get("top5_err", 0.0), m["loss"], lr_it,
                m["grad_norm"], mb_size * world,
            )
            meter.log_iter_stats(cur_epoch, it)
        pending.clear()

    device = next(state.model.parameters()).device
    # The profiler window: one trace a job, of epoch 0, on rank 0.
    prof_dir = cfg.TPU.PROFILE_DIR if cur_epoch == 0 and pmv_logging.is_master_process() else ""
    first, last = profiler_window(data_size)
    prof = None
    stream = DevicePrefetcher(train_loader, device, cfg.TPU.DEVICE_PREFETCH)
    meter.iter_tic()
    for cur_iter, (batch, device_batch) in enumerate(stream):
        if prof_dir and cur_iter == first:
            prof = start_profiler(prof_dir, device)
        epoch_exact = cur_epoch + float(cur_iter) / data_size
        lr = get_lr_at_epoch(cfg, epoch_exact)
        meter.data_toc()
        if cfg.DATA.GET_MISALIGNED_AUDIO and "audio_mis" in device_batch:
            device_batch = dict(device_batch, audio_mis=steps.easy_negatives(
                cfg, device_batch["audio_mis"], cur_epoch))
        metrics = train_step(state, device_batch, lr)
        pending.append((cur_iter, lr, batch["frames"].shape[0], metrics))
        meter.iter_toc()
        if (cur_iter + 1) % flush_every == 0:
            flush_metrics()
        if prof is not None and cur_iter == last:
            stop_profiler(prof, device, first, last, prof_dir)
            prof = None
        meter.iter_tic()
    if prof is not None:  # the epoch ended inside the window
        stop_profiler(prof, device, first, data_size - 1, prof_dir)
    flush_metrics()
    meter.log_epoch_stats(cur_epoch)
    meter.reset()
    return state


def eval_epoch(val_loader, eval_step, meter, cur_epoch, cfg):
    """One pass of ``eval_step`` over ``val_loader`` into the ValMeter;
    returns the epoch's stats. In a multi-process job every rank's
    predictions are gathered (under dp_sp model rank 0's of each model
    group, whose ranks score the same clips), and each step's errors are
    those of the global batch."""
    lay = mesh.layout(cfg)
    meter.iter_tic()
    for cur_iter, (batch, real) in enumerate(distributed.lockstep(val_loader)):
        meter.data_toc()
        audio = {"audio": batch["audio"]} if "audio" in batch else {}
        preds = eval_step(batch["frames"], batch.get("pm"), **audio)
        preds = preds.float().cpu().numpy()  # waits for the device
        labels = batch["labels"]
        if not real or lay.model != 0:
            preds, labels = preds[:0], np.asarray(labels)[:0]
        preds, labels = distributed.gather_host([preds, labels])
        if np.asarray(labels).ndim > 1:  # multi-label: mAP at the epoch's end
            top1_err = top5_err = 0.0
        else:
            top1_err, top5_err = (
                (1.0 - float(n) / preds.shape[0]) * 100.0
                for n in metrics_mod.topks_correct(
                    torch.from_numpy(preds), torch.as_tensor(labels), (1, 5))
            )
        meter.iter_toc()
        meter.update_stats(top1_err, top5_err, preds.shape[0])
        meter.update_predictions(preds, labels)
        meter.log_iter_stats(cur_epoch, cur_iter)
        meter.iter_tic()
    stats = meter.log_epoch_stats(cur_epoch)
    meter.reset()
    return stats


def eval_detection_epoch(val_loader, eval_step, meter, cur_epoch, lay=None):
    """One pass of the detection ``eval_step`` over ``val_loader`` into the
    val ``AVAMeter`` (``test.perform_detection``, under the sequence
    parallelism of ``lay`` model rank 0's boxes); returns the epoch's stats,
    its "map" among them."""
    from pmv_tpu_torch.engine.test import perform_detection

    groundtruth = perform_detection(val_loader, eval_step, meter, cur_epoch, lay)
    stats = meter.log_epoch_stats(cur_epoch, groundtruth)
    meter.reset()
    return stats


def refuse_unported(cfg):
    """Raise for what the config asks for and the port does not run: precise
    BN of a detection model, whose JAX ``stats_step`` calls the model
    without boxes (`pmv_tpu/engine/precise_bn.py:26-30`)."""
    if cfg.DETECTION.ENABLE and cfg.BN.USE_PRECISE_STATS:
        raise NotImplementedError("not ported: BN.USE_PRECISE_STATS with DETECTION.ENABLE")


def train(cfg, device=None):
    """Train a model per ``cfg`` on ``device`` (CUDA by default; raises
    without a CUDA device unless ``device="cpu"``). Returns the result
    string of the reference's train()."""
    device = resolve_device(device)
    pmv_logging.setup_logging(cfg.OUTPUT_DIR)
    distributed.check_world(cfg)
    distributed.check_sequence_parallel(cfg)
    refuse_unported(cfg)
    np.random.seed(cfg.RNG_SEED)
    torch.manual_seed(cfg.RNG_SEED)
    logger.info("Train with config:")
    logger.info(pprint.pformat(cfg))

    multigrid = None
    if cfg.MULTIGRID.LONG_CYCLE or cfg.MULTIGRID.SHORT_CYCLE:
        multigrid = MultigridSchedule()
        cfg = multigrid.init_multigrid(cfg)
    long_cycle = multigrid is not None and cfg.MULTIGRID.LONG_CYCLE

    model = build_model(cfg, device=device, seed=cfg.RNG_SEED)
    if cfg.LOG_MODEL_INFO:
        misc.log_model_info(model, cfg)
    wrapped = None
    if rank_and_world_size()[1] > 1:
        wrapped = distributed.wrap_model(model, cfg.TPU.SHARD_STRATEGY, device,
                                           mesh.layout(cfg))
    state = steps.init_state(cfg, model, wrapped=wrapped)
    val_loader = loader_mod.construct_loader(cfg, "val")

    def set_long_cycle(epoch):
        """The long cycle of ``epoch``: its base shape in cfg and its
        BatchNorm type in the model. Whether the shape changed."""
        _, changed = multigrid.update_long_cycle(cfg, epoch)
        distributed.check_sequence_parallel(
            cfg, what=f"epoch {epoch}'s long cycle of {cfg.TRAIN.BATCH_SIZE} clips x "
            f"{cfg.DATA.NUM_FRAMES} frames x crop {cfg.DATA.TRAIN_CROP_SIZE}: DATA.NUM_FRAMES")
        if changed and swap_norms(model, cfg):
            logger.info("Norms now %s (%d splits)", cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS)
        return changed

    # A checkpoint holds the statistics of the long cycle of its epoch:
    # the model takes that cycle's norms before it loads, and the loop
    # below moves on to the next epoch's, as the run that wrote it did.
    start_epoch = cu.load_train_checkpoint(
        cfg, state, before_load=set_long_cycle if long_cycle else None)
    if (start_epoch == 0 and not cfg.TRAIN.CHECKPOINT_FILE_PATH
            and cfg.MODEL.MODEL_NAME in pretrain.MODELS):
        # The pretrain registry (`Uniformer/slowfast/models/build.py:42-46`).
        pretrain.load_pretrained(cfg, model)
    detection = cfg.DETECTION.ENABLE
    make_eval_step = steps.make_detection_eval_step if detection else steps.make_eval_step
    train_step = steps.make_train_step(cfg, device=device, seed=cfg.RNG_SEED)
    eval_step = make_eval_step(cfg, model, device=device)

    train_loader = loader_mod.construct_loader(cfg, "train")
    train_meter = meters_mod.TrainMeter(len(train_loader), cfg)
    if detection:
        val_meter = meters_mod.AVAMeter(len(val_loader), cfg, "val", video_idx_to_name=getattr(
            val_loader.dataset, "_video_names", None))
    else:
        val_meter = meters_mod.ValMeter(len(val_loader), cfg)
    epoch_timer = meters_mod.EpochTimer()
    writer = None
    if cfg.TENSORBOARD.ENABLE and pmv_logging.is_master_process():
        from pmv_tpu_torch.visualization.tensorboard_vis import TensorboardWriter

        writer = TensorboardWriter(cfg)

    logger.info("Start epoch: %d", start_epoch + 1)
    for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        if cur_epoch > 0 and cfg.DATA.LOADER_CHUNK_SIZE > 0:
            # Chunked-CSV epoch advance (`train_net.py:675-686`).
            num_chunks = math.ceil(
                cfg.DATA.LOADER_CHUNK_OVERALL_SIZE / cfg.DATA.LOADER_CHUNK_SIZE
            )
            cfg.DATA.SKIP_ROWS = cur_epoch % num_chunks * cfg.DATA.LOADER_CHUNK_SIZE
            logger.info("chunked loader: skip_rows %d", cfg.DATA.SKIP_ROWS)
            train_loader = loader_mod.construct_loader(cfg, "train")
            train_meter = meters_mod.TrainMeter(len(train_loader), cfg)
        if long_cycle and set_long_cycle(cur_epoch):
            # A new base shape: the train loader, its meter and the steps
            # anew (`train.py:304-342` of the JAX package).
            train_loader = loader_mod.construct_loader(cfg, "train")
            train_meter = meters_mod.TrainMeter(len(train_loader), cfg)
            train_step = steps.make_train_step(cfg, device=device, seed=cfg.RNG_SEED)
            eval_step = make_eval_step(cfg, model, device=device)
        if multigrid is not None:
            logger.info("Epoch %d: %d clips a step (%d steps), %d frames, crop %d, %s",
                        cur_epoch, cfg.TRAIN.BATCH_SIZE, len(train_loader),
                        cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE,
                        norm_name(cfg))
        train_loader.set_epoch(cur_epoch)
        epoch_timer.epoch_tic()
        train_epoch(train_loader, train_step, state, train_meter, cur_epoch, cfg)
        epoch_timer.epoch_toc()
        logger.info(
            "Epoch %d takes %.2fs. Epochs from %d to %d take %.2fs in "
            "average and %.2fs in median.",
            cur_epoch, epoch_timer.last_epoch_time(), start_epoch, cur_epoch,
            epoch_timer.avg_epoch_time(), epoch_timer.median_epoch_time(),
        )
        if cfg.BN.USE_PRECISE_STATS:
            calculate_and_update_precise_bn(train_loader, state, cfg, device)
        if cu.is_checkpoint_epoch(cfg, cur_epoch):
            cu.save_checkpoint(cfg.OUTPUT_DIR, state, cur_epoch, cfg)
        if misc.is_eval_epoch(cfg, cur_epoch,
                              multigrid.schedule if multigrid is not None else None):
            eval_tic = time.perf_counter()
            if detection:
                stats = eval_detection_epoch(val_loader, eval_step, val_meter, cur_epoch,
                                             mesh.layout(cfg))
            else:
                stats = eval_epoch(val_loader, eval_step, val_meter, cur_epoch, cfg)
            logger.info("Eval of epoch %d takes %.4fs.", cur_epoch,
                        time.perf_counter() - eval_tic)
            if writer is not None:
                writer.add_scalars({f"Val/{tag}": stats[key] for key, tag in (
                    ("top1_err", "Top1_err"), ("top5_err", "Top5_err"), ("map", "mAP"))
                    if key in stats}, global_step=cur_epoch)
    if writer is not None:
        writer.close()

    median = epoch_timer.median_epoch_time() if epoch_timer.epoch_times else 0.0
    result_string = f"_p{misc.params_count(model) / 1e6:.2f}M _t{median / 60:.2f}m " + (
        f"map {val_meter.max_map:.4f}" if detection else
        f"top1 {val_meter.min_top1_err:.2f} top5 {val_meter.min_top5_err:.2f}")
    logger.info("training done: %s", result_string)
    return result_string
