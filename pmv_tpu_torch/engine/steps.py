"""Train and eval steps.

Counterpart of `pmv_tpu/engine/steps.py`. PyTorch runs eagerly, so a step is
a plain function over the model's own parameters; it sets the model's mode
on every call (eval under ``torch.inference_mode()``, train with autograd),
since one model may serve both.

The train step runs the stages of the JAX step in its order: uint8 clip ->
RandAugment -> normalize -> random erasing (float32) -> MixUp/CutMix ->
train-mode forward with DropPath -> loss -> backward -> global grad norm ->
clip and optimizer update -> top-1/top-5 with the mixup top-2 relabel and
the NaN/inf flag. Its random draws come from generators the step owns,
seeded anew at every step from (``seed``, the state's step count), so that
a run resumed from a checkpoint draws what the uninterrupted run drew, as
the JAX step's ``fold_in(rng, state.step)`` does; or from the caller:
``draws`` may carry any of "rand_augment", "erasing", "mixup", "drop_path",
"dropout" (the head's) and "drop_pathway" (AVSlowFast's DropPathway), in the
forms the modules' ``sample`` functions return, so that a test can hand the
port the draws of the JAX package.

AVSlowFast (MODEL.ARCH avslowfast) takes the batch's log-mel "audio" and,
with DATA.GET_MISALIGNED_AUDIO, "audio_mis" beside the frames
(``pack_pathways``); its train-mode forward with the misaligned audio
returns the AVS sync losses, which the step adds to the task loss
(`steps.py:238-256`) and reports beside it. Its eval step takes the
batch's audio, as the JAX package's ``eval_step(state, frames, audio)``.
Its portrait rows have no route (the JAX package's ``pm`` step packs the
transposed clip without the audio and fails, `steps.py:246`): a ``pm``
batch, or a config with DATA.TRAIN_CROP_SIZE_RECT_SWITCH_AUTO or
TEST_CROP_SIZE_RECT_SWITCH_AUTO, raises NotImplementedError.

Detection (DETECTION.ENABLE, the AVA recipes): ``make_train_step`` returns
``make_detection_train_step`` (`steps.py:325-370`), whose batch carries
"boxes", "box_mask" and multi-hot "labels" and whose loss is
``detection_loss`` (over the global batch's valid boxes in a
multi-process job); ``make_detection_eval_step`` is the JAX package's
``det_step`` (`test.py:95-105`). The AVA colour augmentation is a
preprocessing draw ("ava_color") like the others.

Portrait (``pm``) batches, whose "pm" flags mark rows: the JAX package runs a
second module, the portrait specialization over the same parameters, on
the whole batch transposed, and selects per row,
``where(pm, preds_pm, preds)`` (`steps.py:244-252`). Here each row runs
once, in its own orientation (the reference's per-sample split,
`video_model_builder.py:2075-2096`): the landscape rows through the plain
forward, the portrait rows transposed (``x.transpose(2, 3)``) through the
same module with ``hw_switch=True``, and the two results go back into batch
order. That is exact against the select: MViT has no op across rows, the
loss is a mean over rows, the select gives the other branch a zero
gradient, and the DropPath and head-dropout masks are per row, so each
group takes its rows' masks. It does half the work of the select on a mixed
batch.

A model with BatchNorm (UniFormer) does have an op across rows in train
mode, so its train step takes the JAX package's select itself
(``select_by_orientation``): the whole batch landscape, whose batch
statistics cover every row and give the new running statistics; the whole
batch transposed, whose statistics are thrown away; then ``where(pm, ...)``.
At eval BatchNorm reads its running statistics, and the split stays exact.
MODEL.FROZEN_BN holds the running statistics still in training
(`steps.py:223-227`).

In a multi-process job (``parallel/distributed.py``) a rank's step gives the
numbers of the JAX step on the global batch, of which rank r holds rows
[r b, (r + 1) b): the draws are made at the global batch's shape from the
same seed on every rank, and each rank takes its rows; MixUp's partner rows
come from rank W - 1 - r; BatchNorm's statistics are global
(``models/batchnorm.py``); where a forward runs collectives (BatchNorm's
in training, FSDP's) whether any row of the global batch is portrait is
decided across ranks, and then every rank takes the select, so that each
runs the same forwards, and so the same collectives, as the others
(``portrait_route``; elsewhere each rank splits its own rows); the gradient
is that of the global mean loss (DDP or FSDP average the ranks' gradients),
the grad norm is taken over the whole gradient, every shard of it, and the
loss and top-k errors are averaged over the ranks. The step calls ``state.wrapped``, the model wrapped for the
strategy, once per step: DDP expects one forward per backward.

Under TPU.SHARD_STRATEGY dp_sp (``parallel/mesh.py``) the rows above are
those of a data group, of which every rank of a model group holds the
same; the draws, the preprocessing and MixUp run on the whole clip (the
erasing draws are per pixel of the whole batch), then each rank keeps its
frames of the clip (``mesh.Layout.planes``) and runs the forward inside
``mesh.sequence_parallel``; the portrait rows take the whole-batch select,
decided across ranks, since every forward runs collectives.
"""

import numpy as np
import torch
import torch.nn.functional as F

from pmv_tpu_torch.data import color_jitter
from pmv_tpu_torch.data.ava import MAX_BOXES
from pmv_tpu_torch.data.mixup import MixUp, mixup_target
from pmv_tpu_torch.data.rand_augment import RandAugment, num_groups
from pmv_tpu_torch.data.random_erasing import random_erasing, sample_random_erasing
from pmv_tpu_torch.engine.train_state import TrainState
from pmv_tpu_torch.models import optimizer as optim
from pmv_tpu_torch.models.batchnorm import frozen_stats, has_batchnorm
from pmv_tpu_torch.models.losses import get_loss_func
from pmv_tpu_torch.parallel import distributed, mesh
from pmv_tpu_torch.utils.device import rank_and_world_size, resolve_device


class Preprocess:
    """On-device preprocessing (`make_preprocess_fn`, `:35-123`): uint8
    [B, T, H, W, C] -> float32, in the channel order of DATA.USE_BGR_ORDER
    (`kinetics.py:443-448` of the reference); in training, in the JAX
    package's order, the AVA colour augmentation (DETECTION.ENABLE with
    AVA.TRAIN_USE_COLOR_AUGMENTATION: ColorJitter at hue 0 unless
    AVA.TRAIN_PCA_JITTER_ONLY, then the PCA lighting jitter), the time
    difference (DATA.TIME_DIFF_PROB), the SSL colour jitter
    (DATA.SSL_COLOR_JITTER, with SSL_MOCOV2_AUG and COLOR_RND_GRAYSCALE),
    RandAugment (AUG.AA_TYPE), then normalize, then random erasing
    (AUG.RE_PROB). ``sample`` draws the augmentation's parameters;
    ``__call__`` applies them."""

    # The draws, in the order a step samples them.
    DRAWS = ("ava_color", "time_diff", "ssl_color", "rand_augment", "erasing")

    def __init__(self, cfg, train, device):
        self.device = device
        self.ava_color = None
        if train and cfg.DETECTION.ENABLE and cfg.AVA.TRAIN_USE_COLOR_AUGMENTATION:
            self.ava_color = dict(pca_only=cfg.AVA.TRAIN_PCA_JITTER_ONLY,
                                  eigval=cfg.DATA.TRAIN_PCA_EIGVAL,
                                  eigvec=cfg.DATA.TRAIN_PCA_EIGVEC)
        mean = torch.tensor(cfg.DATA.MEAN, dtype=torch.float32) * 255.0
        inv_std = 1.0 / (torch.tensor(cfg.DATA.STD, dtype=torch.float32) * 255.0)
        self.mean, self.inv_std = mean.to(device), inv_std.to(device)
        self.use_bgr = cfg.DATA.USE_BGR_ORDER
        self.time_diff_prob = cfg.DATA.TIME_DIFF_PROB if train else 0.0
        self.ssl_color = None
        if train and cfg.DATA.SSL_COLOR_JITTER:
            self.ssl_color = dict(
                bri_con_sat=tuple(cfg.DATA.SSL_COLOR_BRI_CON_SAT),
                hue=cfg.DATA.SSL_COLOR_HUE,
                p_convert_gray=cfg.DATA.COLOR_RND_GRAYSCALE,
                moco_v2_aug=cfg.DATA.SSL_MOCOV2_AUG,
                blur_sigma=(cfg.DATA.SSL_BLUR_SIGMA_MIN[1], cfg.DATA.SSL_BLUR_SIGMA_MAX[1]),
            )
        use_ra = train and cfg.AUG.ENABLE and cfg.AUG.AA_TYPE
        self.rand_augment = RandAugment(cfg.AUG.AA_TYPE) if use_ra else None
        self.ra_groups = cfg.AUG.RA_GROUPS
        self.re_prob = cfg.AUG.RE_PROB if train and cfg.AUG.ENABLE else 0.0
        self.re_mode = cfg.AUG.RE_MODE

    def sample(self, shape, generator, device_generator, needed=DRAWS):
        """The draws named in ``needed`` that this preprocessing uses."""
        draws = {}
        if self.ava_color is not None and "ava_color" in needed:
            draws["ava_color"] = color_jitter.sample_ava_color(
                shape[0], generator, self.ava_color["pca_only"])
        if self.time_diff_prob > 0 and "time_diff" in needed:
            draws["time_diff"] = color_jitter.sample_time_difference(
                shape[0], generator, self.time_diff_prob)
        if self.ssl_color is not None and "ssl_color" in needed:
            draws["ssl_color"] = color_jitter.sample_ssl_color_jitter(
                shape[0], generator, **self.ssl_color)
        if self.rand_augment is not None and "rand_augment" in needed:
            groups = num_groups(shape[0], self.ra_groups)
            draws["rand_augment"] = self.rand_augment.sample(groups, generator)
        if self.re_prob > 0 and "erasing" in needed:
            draws["erasing"] = sample_random_erasing(
                shape, generator, device_generator, self.device,
                probability=self.re_prob, mode=self.re_mode,
            )
        return draws

    def __call__(self, frames, draws=None, dtype=torch.float32):
        """The preprocessed clips, computed in ``dtype`` (float32; float64
        for a model of float64 activations, so that its checks see no
        float32 rounding in the augmentation)."""
        x = frames.to(dtype)
        if self.use_bgr:
            x = x.flip(-1)
        if self.ava_color is not None:
            x = color_jitter.ava_color(x, draws["ava_color"], self.ava_color["eigval"],
                                       self.ava_color["eigvec"])
        if self.time_diff_prob > 0:
            x = color_jitter.augment_time_difference(x, draws["time_diff"])
        if self.ssl_color is not None:
            x = color_jitter.ssl_color_jitter(x, draws["ssl_color"],
                                              self.ssl_color["moco_v2_aug"])
        if self.rand_augment is not None:
            x = self.rand_augment.apply_batch(x, draws["rand_augment"])
        x = (x - self.mean) * self.inv_std
        if self.re_prob > 0:
            x = random_erasing(x, draws["erasing"])
        return x


def make_preprocess_fn(cfg, train, device=None):
    """``Preprocess`` on ``device`` (no augmentation when ``train`` is
    False)."""
    return Preprocess(cfg, train, resolve_device(device))


def make_eval_preprocess_fn(cfg, device=None):
    """uint8 frames -> normalized float32, the same for every split."""
    return make_preprocess_fn(cfg, train=False, device=device)


def pack_pathways(cfg, x, audio=None, audio_mis=None):
    """[B, T, H, W, C] -> the per-pathway list (`steps.py:150-167`): [x] for a
    single-pathway arch; for SlowFast [slow, fast], the slow pathway every
    SLOWFAST.ALPHA-th frame from the first, ``x[:, ::ALPHA]``, and the fast
    one ``x``; for AVSlowFast [slow, fast, audio], and audio_mis after them
    where it is given. Inside ``mesh.sequence_parallel`` ``x`` is a rank's
    frames of the clip and the audio the whole clip's: the rank's every
    ALPHA-th frame is the clip's slow frames on it only where its first
    frame's number in the clip is a multiple of ALPHA, so a rank's frames
    that ALPHA does not divide raise ValueError."""
    if cfg.MODEL.ARCH in cfg.MODEL.SINGLE_PATHWAY_ARCH:
        return [x]
    if cfg.MODEL.ARCH == "slowfast":
        return [slow_frames(cfg, x), x]
    if cfg.MODEL.ARCH == "avslowfast":
        if audio is None:
            raise ValueError("AVSlowFast needs the batch's audio (a Kinetics_av loader)")
        inputs = [slow_frames(cfg, x), x, audio]
        return inputs if audio_mis is None else inputs + [audio_mis]
    raise NotImplementedError(f"arch {cfg.MODEL.ARCH} is not ported yet")


def slow_frames(cfg, x):
    """The slow pathway's frames of [B, T, H, W, C] ``x``: every
    SLOWFAST.ALPHA-th from the first (``pack_pathways``)."""
    alpha = cfg.SLOWFAST.ALPHA
    if mesh.active() is not None and x.shape[1] % alpha:
        raise ValueError(f"a rank's {x.shape[1]} frames are not a multiple of SLOWFAST.ALPHA "
                         f"{alpha}: give each rank a multiple of it (DATA.NUM_FRAMES / the "
                         "model axis)")
    return x[:, ::alpha]


def model_input(cfg, x, audio=None, audio_mis=None):
    """What a model's forward takes: the one pathway's tensor, or the list of
    ``pack_pathways``."""
    inputs = pack_pathways(cfg, x, audio, audio_mis)
    return inputs[0] if len(inputs) == 1 else inputs


def audio_of(batch, key, device):
    """The batch's float32 log-mel clips under ``key`` on ``device``, or
    None."""
    value = batch.get(key)
    if value is None:
        return None
    return torch.as_tensor(value).to(device, torch.float32, non_blocking=True)


def refuse_portrait_audio(cfg, pm=None):
    """Raise for portrait rows (``pm``, as ``portrait_rows`` gives them) or a
    portrait-switching config on AVSlowFast (module docstring)."""
    if cfg.MODEL.ARCH != "avslowfast":
        return
    if (pm is not None or cfg.DATA.TRAIN_CROP_SIZE_RECT_SWITCH_AUTO
            or cfg.DATA.TEST_CROP_SIZE_RECT_SWITCH_AUTO):
        raise NotImplementedError(
            "portrait (pm) rows on AVSlowFast: the portrait route has no audio, as "
            "the JAX package's pm step packs the transposed clip without it and fails")


def easy_negatives(cfg, audio_mis, epoch):
    """The AVS easy negatives (the JAX package's ``prepare_batch``,
    `train.py:96-109`, the reference's `loader.py:25-43`): over the global
    batch of n rows, before DATA.MIX_NEG_EPOCH every row takes the next
    row's misaligned audio (a clip of another video), from that epoch on
    only the first max(int(EASY_NEG_RATIO n), 1) rows do, in a cycle among
    themselves, the rest keeping their own (hard negatives). Returns this
    rank's rows; in a multi-process job every rank's clips are gathered
    first, since the roll crosses ranks."""
    rank, world = rank_and_world_size()
    audio_mis = torch.as_tensor(audio_mis)
    b = audio_mis.shape[0]
    n = b * world
    sn = max(int(cfg.DATA.EASY_NEG_RATIO * n), 1) if epoch >= cfg.DATA.MIX_NEG_EPOCH else n
    idx = np.arange(n)
    idx[:sn] = np.arange(1, sn + 1) % sn
    if world > 1:
        audio_mis = distributed.gather_rows(audio_mis).flatten(0, 1)
    return audio_mis.index_select(0, torch.as_tensor(idx[rank * b:(rank + 1) * b],
                                                     device=audio_mis.device))


def _transposed(x):
    """An input with H and W swapped: a tensor, or each pathway of a list
    (the same as packing the swapped clip: the pathways differ in T only)."""
    if isinstance(x, list):
        return [t.transpose(2, 3) for t in x]
    return x.transpose(2, 3)


def _device_of(x):
    return (x[0] if isinstance(x, list) else x).device


def _rows(masks, index):
    """The rows ``index`` of a per-row mask, or of each mask in a nested
    list or tuple of them (DropPath's per-block pairs, a list of pathways);
    None stays None."""
    if masks is None:
        return None
    if isinstance(masks, (list, tuple)):
        return type(masks)(_rows(m, index) for m in masks)
    return masks.index_select(0, index.to(masks.device))


def portrait_rows(pm, batch_size):
    """``pm`` (host flags) as a bool array of ``batch_size`` rows, or None
    when no row is portrait."""
    if pm is None:
        return None
    pm = np.asarray(pm, bool).reshape(batch_size)
    return pm if pm.any() else None


def portrait_route(model, pm, batch_size, train, lay=None):
    """(route, flags): how a batch's rows run by orientation, and
    ``portrait_rows``. The JAX package's whole-batch select
    (``select_by_orientation``) where the forwards must be the whole
    batch's or the same on every rank: BatchNorm in training, whose
    statistics cover every row (every rank's in a multi-process job), and,
    in a multi-process job, FSDP, which gathers each block's parameters in
    every forward, and the sequence parallelism of ``lay`` (a
    ``mesh.Layout``), whose every forward runs collectives. There the
    decision is taken across ranks: the flags are all False, not None, on a
    rank without portrait rows when another rank has some, so that every
    rank runs both passes and the same collectives. Elsewhere (MViT's train
    step, any eval step, under ``dp``) each row runs once, in its
    orientation (``forward_by_orientation``), which runs no collective."""
    pm = portrait_rows(pm, batch_size)
    world = rank_and_world_size()[1]
    sharded = world > 1 and distributed.is_sharded(next(model.parameters()))
    sequence = lay is not None and lay.sequence_parallel
    if not (train and has_batchnorm(model) or sharded or sequence):
        return forward_by_orientation, pm
    if world > 1 and distributed.any_across_ranks(pm is not None) and pm is None:
        pm = np.zeros(batch_size, bool)
    return select_by_orientation, pm


def slice_rows(masks, start, stop, batch):
    """Rows [start, stop) of a ``batch``-row batch's per-row masks (a mask
    of k x ``batch`` rows holds k rows a clip, clip by clip: UniFormer's
    split blocks), or of each mask in a nested list or tuple of them; None
    stays None."""
    if masks is None:
        return None
    if isinstance(masks, (list, tuple)):
        return type(masks)(slice_rows(m, start, stop, batch) for m in masks)
    k = masks.shape[0] // batch
    return masks[start * k:stop * k]


def local_draws(draws, start, stop, batch):
    """The draws of rows [start, stop) of a ``batch``-row batch: per-row
    draws (the SSL and AVA colours', the time difference's, MaskFeat's masks
    and HOG bins, the detection head's dropout of M rows a clip too) sliced,
    RandAugment's groups that hold the rows, MixUp's scalars as they are."""
    if (start, stop) == (0, batch):
        return draws
    out = dict(draws)
    if "rand_augment" in draws:
        out["rand_augment"] = draws["rand_augment"].rows(start, stop, batch)
    for key in ("erasing", "ssl_color", "ava_color"):
        if key in draws:
            out[key] = draws[key].rows(start, stop)
    if "time_diff" in draws:
        out["time_diff"] = draws["time_diff"][start:stop]
    for key in ("drop_path", "dropout", "mask", "hog_bins"):
        if key in draws:
            out[key] = slice_rows(draws[key], start, stop, batch)
    return out


def forward_by_orientation(model, x, pm, drop_path_masks=None, head_dropout_mask=None,
                           **kwargs):
    """``model`` on each row of ``x`` (``model_input``: [B, T, H, W, C], or
    a list of pathways) in its orientation: rows where ``pm`` (a host bool
    array, or None) is set run transposed through the portrait
    specialization (``hw_switch=True``), the others through the plain
    forward; the outputs come back in batch order. ``kwargs`` go to the
    model as they are (AVSlowFast's ``drop_pathway``)."""
    if pm is None:
        return model(x, drop_path_masks=drop_path_masks,
                     head_dropout_mask=head_dropout_mask, **kwargs)
    device = _device_of(x)
    groups = (np.flatnonzero(~pm), np.flatnonzero(pm))
    outs = []
    for rows, portrait in zip(groups, (False, True)):
        if len(rows) == 0:
            continue
        index = torch.as_tensor(rows, device=device)
        xg = _rows(x, index)
        outs.append(model(
            _transposed(xg) if portrait else xg,
            drop_path_masks=_rows(drop_path_masks, index),
            head_dropout_mask=_rows(head_dropout_mask, index),
            hw_switch=portrait, **kwargs,
        ))
    inverse = torch.as_tensor(np.argsort(np.concatenate(groups)), device=device)
    return torch.cat(outs).index_select(0, inverse)


def select_by_orientation(model, x, pm, drop_path_masks=None, head_dropout_mask=None,
                          **kwargs):
    """The JAX package's portrait select (`steps.py:238-252`): ``model`` on
    the whole batch, then on the whole batch transposed (``hw_switch=True``;
    each pathway of a list transposed, which is the JAX step's packing of
    the transposed clip) with its BatchNorm running statistics left as they
    are, and per row the output of the row's orientation (``pm``, a host
    bool array, or None). ``kwargs`` go to the model as they are."""
    land = model(x, drop_path_masks=drop_path_masks, head_dropout_mask=head_dropout_mask,
                 **kwargs)
    if pm is None:
        return land
    with frozen_stats(model):
        port = model(_transposed(x), drop_path_masks=drop_path_masks,
                     head_dropout_mask=head_dropout_mask, hw_switch=True, **kwargs)
    return torch.where(torch.as_tensor(pm, device=_device_of(x))[:, None], port, land)


def _top_k(scores, k):
    """Indices of the k largest scores per row, the lower index first among
    equal scores (as ``jax.lax.top_k``)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]


def make_draw_sampler(preprocess, seed, device):
    """sample(shape, given, step, extra) -> a train step's draws: the
    ``given`` ones, then, of those not given, the preprocessing's
    (``Preprocess.DRAWS``) and each of ``extra`` (name -> fn(host generator,
    device generator), drawn in that order), from generators seeded anew
    from (``seed``, ``step``), so that a step's draws depend on the seed and
    the step count alone. ``step`` may be a tuple of ints (a step and a
    view of it)."""
    generator = torch.Generator()
    device_generator = torch.Generator(device)

    def sample(shape, given, step, extra):
        step = step if isinstance(step, tuple) else (step,)
        step_seed = int(np.random.SeedSequence((seed, *step)).generate_state(1)[0])
        generator.manual_seed(step_seed)
        device_generator.manual_seed(step_seed)
        missing = (set(Preprocess.DRAWS) | set(extra)) - set(given)
        draws = dict(given)
        draws.update(preprocess.sample(shape, generator, device_generator, missing))
        for name, draw in extra.items():
            if name in missing:
                draws[name] = draw(generator, device_generator)
        return draws

    return sample


def make_train_step(cfg, device=None, seed=0):
    """Returns train_step(state, batch, lr, draws=None) -> metrics.

    ``batch`` holds uint8 "frames" [B, T, H, W, 3] and int "labels" [B]
    (arrays or tensors), and for AVSlowFast float32 "audio" [B, T_spec, M]
    and "audio_mis", moved to ``device`` (CUDA by default; raises
    without a CUDA device unless ``device="cpu"``), the device of
    ``state.model``. The rows that the batch's optional "pm" flags mark run
    through the portrait specialization (the module docstring); this is
    also the JAX package's ``make_train_step(model_pm=...)``. The step
    updates ``state`` in place and returns "loss", "grad_norm" (before
    clipping), "top1_err", "top5_err", "nan" and AVSlowFast's AVS losses
    ("s{i}_avs", in the loss already) as tensors on the device, so that the
    host reads them only when it logs. In a multi-process job the
    batch is this rank's rows, ``draws`` are those of the global batch, and
    the metrics are the global batch's (the module docstring). With
    DETECTION.ENABLE it is ``make_detection_train_step``'s.
    """
    if cfg.DETECTION.ENABLE:
        return make_detection_train_step(cfg, device, seed)
    device = resolve_device(device)
    refuse_portrait_audio(cfg)
    loss_fun = get_loss_func(cfg.MODEL.LOSS_FUNC)
    preprocess = make_preprocess_fn(cfg, train=True, device=device)
    mixup_fn = (
        MixUp(
            mixup_alpha=cfg.MIXUP.ALPHA,
            cutmix_alpha=cfg.MIXUP.CUTMIX_ALPHA,
            mix_prob=cfg.MIXUP.PROB,
            switch_prob=cfg.MIXUP.SWITCH_PROB,
            label_smoothing=cfg.MIXUP.LABEL_SMOOTH_VALUE,
            num_classes=cfg.MODEL.NUM_CLASSES,
        )
        if cfg.MIXUP.ENABLE
        else None
    )
    draw = make_draw_sampler(preprocess, seed, device)

    def sample_draws(model, shape, given, step):
        extra = {}
        if mixup_fn is not None:
            extra["mixup"] = lambda g, _: mixup_fn.sample(shape[2], shape[3], g)
        extra["drop_path"] = lambda _, g: model.sample_drop_path_masks(shape[0], g, device)
        extra["dropout"] = lambda _, g: model.sample_head_dropout_mask(shape[0], g, device)
        if hasattr(model, "sample_drop_pathway"):  # one decision for every rank
            extra["drop_pathway"] = lambda g, _: model.sample_drop_pathway(g)
        return draw(shape, given, step, extra)

    def train_step(state: TrainState, batch, lr, draws=None):
        model, optimizer = state.model, state.optimizer
        model.train()
        frames = torch.as_tensor(batch["frames"]).to(device, non_blocking=True)
        labels = torch.as_tensor(batch["labels"]).to(device, non_blocking=True)
        lay = mesh.layout(cfg)
        rank, world = lay.data, lay.data_size
        b = frames.shape[0]
        shape = (b * world, *frames.shape[1:])
        draws = local_draws(sample_draws(model, shape, draws or {}, state.step),
                            rank * b, (rank + 1) * b, shape[0])

        def partner_rows_flipped(t):  # the batch reversed, in one process
            return distributed.partner_rows(t, lay).flip(0)

        x = preprocess(frames, draws)
        if mixup_fn is not None:
            x, targets = mixup_fn.apply(x, labels, draws["mixup"], partner_rows_flipped)
        elif cfg.MODEL.LOSS_FUNC == "soft_cross_entropy":
            targets = mixup_target(
                labels, cfg.MODEL.NUM_CLASSES, 1.0, cfg.MIXUP.LABEL_SMOOTH_VALUE
            )
        else:
            targets = labels
        x = local_frames(x, lay)
        route, pm = portrait_route(model, batch.get("pm"), b, train=True, lay=lay)
        refuse_portrait_audio(cfg, pm)
        audio = (audio_of(batch, "audio", device), audio_of(batch, "audio_mis", device))
        kwargs = dict(drop_path_masks=draws["drop_path"], head_dropout_mask=draws["dropout"])
        if "drop_pathway" in draws:
            kwargs["drop_pathway"] = draws["drop_pathway"]
        with frozen_stats(model, cfg.MODEL.FROZEN_BN), mesh.sequence_parallel(lay):
            args = (model_input(cfg, x, *audio), pm)
            if state.wrapped is None:
                preds = route(model, *args, **kwargs)
            else:
                preds = state.wrapped(route, *args, **kwargs)
        aux = {}
        if isinstance(preds, tuple):  # AVSlowFast's AVS losses, added to the loss
            preds, aux = preds
        loss = loss_fun(preds.float(), targets)
        for value in aux.values():
            loss = loss + value
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = optim.global_norm(
            p.grad if p.grad is not None else torch.zeros_like(p)
            for p in model.parameters()
        )
        optim.set_lr(optimizer, lr)
        optimizer.step(grad_norm=grad_norm)
        state.step += 1

        with torch.no_grad():
            # Top-k errors; multi-label batches skip them, as the reference.
            # With mixup the top-2 of the mixed target relabel the batch
            # (`train_net.py:210-219`): the second label's score merges
            # into the first.
            if labels.dim() > 1:
                correct1 = correct5 = torch.ones(preds.shape[0], device=device)
            else:
                metric_preds = preds.detach().float()
                metric_labels = labels
                if mixup_fn is not None:
                    rows = torch.arange(metric_preds.shape[0], device=device)
                    top2i = _top_k(targets, 2)
                    metric_preds = metric_preds.clone()
                    metric_preds[rows, top2i[:, 0]] += metric_preds[rows, top2i[:, 1]]
                    metric_preds[rows, top2i[:, 1]] = 0.0
                    metric_labels = top2i[:, 0]
                top = _top_k(metric_preds, min(5, preds.shape[-1]))
                correct1 = (top[:, :1] == metric_labels[:, None]).any(dim=1)
                correct5 = (top == metric_labels[:, None]).any(dim=1)
            loss, top1_err, top5_err, *aux_values = distributed.all_reduce_mean(torch.stack([
                t.detach().to(loss.dtype) for t in (
                    loss,
                    (1.0 - correct1.float().mean()) * 100.0,
                    (1.0 - correct5.float().mean()) * 100.0,
                    *aux.values(),
                )
            ])).unbind()
            return {
                "loss": loss,
                "grad_norm": grad_norm,
                "top1_err": top1_err,
                "top5_err": top5_err,
                "nan": ~(torch.isfinite(loss) & torch.isfinite(grad_norm)),
                **dict(zip(aux, aux_values)),
            }

    train_step.sample_draws = (
        lambda model, shape, step=0: sample_draws(model, tuple(shape), {}, step)
    )
    return train_step


def local_frames(x, lay):
    """This rank's frames ([B, T, ...] -> [B, T / M, ...]) of a clip under
    the sequence parallelism of ``lay``; ``x`` itself without it."""
    if not lay.sequence_parallel:
        return x
    start, stop = lay.planes(x.shape[1])
    return x[:, start:stop]


def _call(model, x, **kwargs):
    return model(x, **kwargs)


def detection_loss(preds, labels, box_mask):
    """The detection step's loss (`steps.py:350-355`): per box the mean over
    the classes of the binary cross-entropy of the float32 logits, summed
    over the valid boxes and divided by their count (at least 1). In a
    multi-process job the count is the global batch's, and each rank's sum
    is scaled by the world size: the ranks' mean, which DDP's averaged
    gradient follows, is the global batch's loss."""
    per_box = F.binary_cross_entropy_with_logits(preds.float(), labels.float(),
                                                 reduction="none").mean(dim=-1)
    mask = box_mask.to(per_box.dtype)
    count = mask.sum().detach()
    world = rank_and_world_size()[1]
    if world > 1:
        count = distributed.all_reduce_sum(count)
    return (per_box * mask).sum() * world / torch.clamp(count, min=1.0)


def make_detection_train_step(cfg, device=None, seed=0):
    """Returns train_step(state, batch, lr, draws=None) -> metrics, the
    detection step of AVA (`make_detection_train_step`, `steps.py:325-370`).

    ``batch`` holds uint8 "frames" [B, T, H, W, 3], "boxes" [B, M, 4] in the
    clip's pixels, bool "box_mask" [B, M] and multi-hot "labels" [B, M,
    NUM_CLASSES]. The preprocessing (the AVA colour augmentation where the
    config asks for it), the train-mode forward with the boxes and the
    head's dropout over B x M rows, ``detection_loss``, the backward, the
    grad norm, the optimizer; portrait flags are not read (AVA's are all
    False), as in the JAX package. Draws as ``make_train_step``'s: "dropout"
    and the preprocessing's. Returns "loss", "grad_norm", "top1_err" and
    "top5_err" (0, as the JAX step's) and "nan"; in a multi-process job the
    global batch's (``detection_loss``)."""
    device = resolve_device(device)
    preprocess = make_preprocess_fn(cfg, train=True, device=device)
    draw = make_draw_sampler(preprocess, seed, device)

    def sample_draws(model, shape, given, step, rows):
        head = model.head
        extra = {"dropout": lambda _, g: head.dropout.sample((shape[0] * rows, head.dim_in),
                                                             g, device)}
        return draw(shape, given, step, extra)

    def train_step(state: TrainState, batch, lr, draws=None):
        model, optimizer = state.model, state.optimizer
        model.train()
        frames = torch.as_tensor(batch["frames"]).to(device, non_blocking=True)
        boxes = torch.as_tensor(batch["boxes"]).to(device, torch.float32, non_blocking=True)
        box_mask = torch.as_tensor(batch["box_mask"]).to(device, torch.bool, non_blocking=True)
        labels = torch.as_tensor(batch["labels"]).to(device, torch.float32, non_blocking=True)
        rank, world = rank_and_world_size()
        b, m = boxes.shape[:2]
        shape = (b * world, *frames.shape[1:])
        draws = local_draws(sample_draws(model, shape, draws or {}, state.step, m),
                            rank * b, (rank + 1) * b, shape[0])
        x = model_input(cfg, preprocess(frames, draws))
        kwargs = dict(boxes=boxes, box_mask=box_mask, head_dropout_mask=draws["dropout"])
        with frozen_stats(model, cfg.MODEL.FROZEN_BN):
            if state.wrapped is None:
                preds = model(x, **kwargs)
            else:
                preds = state.wrapped(_call, x, **kwargs)
        loss = detection_loss(preds, labels, box_mask)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = optim.global_norm(
            p.grad if p.grad is not None else torch.zeros_like(p)
            for p in model.parameters()
        )
        optim.set_lr(optimizer, lr)
        optimizer.step(grad_norm=grad_norm)
        state.step += 1
        loss = distributed.all_reduce_mean(loss.detach())
        zero = torch.zeros((), device=device)
        return {"loss": loss, "grad_norm": grad_norm, "top1_err": zero, "top5_err": zero,
                "nan": ~(torch.isfinite(loss) & torch.isfinite(grad_norm))}

    train_step.sample_draws = (
        lambda model, shape, step=0, rows=MAX_BOXES: sample_draws(model, tuple(shape), {},
                                                                  step, rows)
    )
    return train_step


def make_detection_eval_step(cfg, model, device=None):
    """eval_step(frames, boxes, box_mask) -> the boxes' sigmoid scores [B, M,
    NUM_CLASSES], 0 on padded boxes (the JAX package's ``det_step``,
    `test.py:95-105`); the inputs as ``make_detection_train_step``'s
    batch's, moved to ``device``."""
    device = resolve_device(device)
    preprocess = make_eval_preprocess_fn(cfg, device)

    @torch.inference_mode()
    def eval_step(frames, boxes, box_mask):
        model.eval()
        frames = torch.as_tensor(frames).to(device, non_blocking=True)
        boxes = torch.as_tensor(boxes).to(device, torch.float32, non_blocking=True)
        box_mask = torch.as_tensor(box_mask).to(device, torch.bool, non_blocking=True)
        return model(model_input(cfg, preprocess(frames)), boxes=boxes, box_mask=box_mask)

    return eval_step


def make_eval_step(cfg, model, device=None):
    """eval_step(frames, pm=None, audio=None) -> scores [B, NUM_CLASSES]
    (softmax'd head).

    ``frames`` is a uint8 [B, T, H, W, 3] array or tensor, and ``audio``
    AVSlowFast's float32 log-mel clips [B, T_spec, M]; they are moved to
    ``device`` (CUDA by default; raises without a CUDA device unless
    ``device="cpu"``), which must be the model's device. Rows that ``pm``
    marks run through the portrait specialization: this is also the JAX
    package's ``_make_pm_eval_step`` (`train.py:183-199`). In a
    multi-process job every rank calls it the same number of times; under
    ``fsdp`` every rank takes the select (exact at eval), so that each runs
    the same forwards (``portrait_route``). Under dp_sp the ranks of a model
    group take the same rows, each its frames of the clip after the
    preprocessing, and return the same scores."""
    device = resolve_device(device)
    refuse_portrait_audio(cfg)
    preprocess = make_eval_preprocess_fn(cfg, device)

    @torch.inference_mode()
    def eval_step(frames, pm=None, audio=None):
        model.eval()
        frames = torch.as_tensor(frames).to(device, non_blocking=True)
        lay = mesh.layout(cfg)
        route, pm = portrait_route(model, pm, frames.shape[0], train=False, lay=lay)
        refuse_portrait_audio(cfg, pm)
        audio = audio_of({"audio": audio}, "audio", device)
        with mesh.sequence_parallel(lay):
            return route(model, model_input(cfg, local_frames(preprocess(frames), lay), audio),
                         pm)

    return eval_step


def make_feat_step(cfg, model, device=None):
    """feat_step(frames) -> pooled backbone features [B, C]
    (TEST.FEAT_EXTRACT, `steps.py:384-403`), as the JAX package pools them:
    the mean of MViT's last tokens, the cls token included, or of
    UniFormer's feature grid [B, T, H, W, C] over T, H and W."""
    device = resolve_device(device)
    preprocess = make_eval_preprocess_fn(cfg, device)

    @torch.inference_mode()
    def feat_step(frames):
        model.eval()
        frames = torch.as_tensor(frames).to(device, non_blocking=True)
        feats = model(model_input(cfg, preprocess(frames)), return_features=True)
        if isinstance(feats, tuple):  # MViT's (tokens, thw)
            feats = feats[0]
        return feats.float().mean(dim=tuple(range(1, feats.dim() - 1)))

    return feat_step


def init_state(cfg, model, optimizer=None, wrapped=None):
    """TrainState at step 0 over ``model`` (`init_state`, `:406-445`); the
    optimizer is built from the model's parameters when not given, which
    must come after ``wrapped`` was made from ``model`` (FSDP's parameters
    are its shards)."""
    if optimizer is None:
        optimizer = optim.construct_optimizer(model, cfg)
    return TrainState(step=0, model=model, optimizer=optimizer, wrapped=wrapped)
