"""Kinetics / PMV-400 dataset.

Counterpart of `pmv_tpu/data/kinetics.py` (`MViT/slowfast/datasets/
kinetics.py:30-603`), over the port's own decode library:

- CSV split list via `DATA.LABEL_PATH_TEMPLATE.format(mode, PM_SUBSET)`
  with `DATA.PATH_LABEL_SEPARATOR`; chunked loading of LOADER_CHUNK_SIZE
  rows from DATA.SKIP_ROWS in train mode.
- test mode unrolls each video into NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS
  deterministic views.
- 100-retry decode loop with random replacement during training.
- PMV rect crops with auto landscape/portrait switching and the per-sample
  `pm` flag; portrait crops are transposed to the landscape layout.
- repeated augmentation (AUG.NUM_SAMPLE copies of one decode).

Every random draw of a sample comes from one ``np.random.Generator`` seeded
with (RNG_SEED, epoch, index), so a sample is a function of the seed, the
epoch (``_set_epoch_num``) and its index; the JAX package draws from an
unseeded generator. Test mode draws nothing. The host stops at uint8
crops [T, H, W, C]; RandAugment, normalization, erasing and mixup run on
the device in the train step.

Contrastive multi-clip views (DATA.TRAIN_CROP_NUM_TEMPORAL or
TRAIN_CROP_NUM_SPATIAL > 1, train mode): TRAIN_CROP_NUM_TEMPORAL temporal
windows (``video_decoder.decode_multi_clip``, their gaps within
CONTRASTIVE.DELTA_CLIPS_MIN/MAX), each cropped and flipped
TRAIN_CROP_NUM_SPATIAL times on its own, stacked on a view axis: the
sample's frames are [V, T, H, W, C], V = the product of the two
(`kinetics.py:301-330, 360-390` of the JAX package, draw for draw).

With AUG.GEN_MASK_LOADER a train sample also carries "mask", MaskFeat's
blockwise mask on the AUG.MASK_WINDOW_SIZE grid, flattened to booleans
(``data/masking.py::gen_mask``), drawn last from the sample's generator, as
the JAX package draws it after the decode (`kinetics.py:237-242`).

A multigrid short cycle's sample comes indexed (index, phase) from the
loader (``data/loader.py``), and phases 0 and 1 crop smaller
(``_sample_params``).

With DATA.DUMMY_LOAD the first sample decoded is returned for every later
index (`kinetics.py:193-194, 243-244` of the JAX package): a loader
benchmark without the decode.
"""

import math
import os

import numpy as np

from pmv_tpu_torch.data import masking, spatial, transform, video_decoder
from pmv_tpu_torch.data.build import DATASET_REGISTRY
from pmv_tpu_torch.native import binding
from pmv_tpu_torch.utils import logging as pmv_logging

logger = pmv_logging.get_logger(__name__)


@DATASET_REGISTRY.register(name="Kinetics")
class Kinetics:
    _NUM_RETRIES = 100

    def __init__(self, cfg, mode):
        assert mode in ["train", "val", "test"]
        self.cfg = cfg
        self.mode = mode
        self.epoch = 0
        self.dummy_output = None  # DATA.DUMMY_LOAD's first sample
        if mode in ["train", "val"]:
            self._num_clips = 1
        else:
            self._num_clips = (
                cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
            )
        self._construct_loader()

    def _construct_loader(self):
        cfg = self.cfg
        csv_name = cfg.DATA.LABEL_PATH_TEMPLATE.format(
            self.mode, cfg.DATA.PM_SUBSET
        )
        path_to_file = os.path.join(cfg.DATA.PATH_TO_DATA_DIR, csv_name)
        if not os.path.exists(path_to_file):
            raise FileNotFoundError(f"{path_to_file} not found")
        self._path_to_videos = []
        self._labels = []
        self._spatial_temporal_idx = []
        self.skip_rows = cfg.DATA.SKIP_ROWS
        self.use_chunk_loading = (
            self.mode == "train" and cfg.DATA.LOADER_CHUNK_SIZE > 0
        )
        with open(path_to_file, "r") as f:
            if self.use_chunk_loading:
                rows = self._get_chunk(f, cfg.DATA.LOADER_CHUNK_SIZE)
            else:
                rows = (line for line in f)
            for line in rows:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(cfg.DATA.PATH_LABEL_SEPARATOR)
                # 2 fields = path,label; 3 = path,fn,label; 1 = path only.
                if len(parts) == 2:
                    path, label = parts
                elif len(parts) == 3:
                    path, _, label = parts
                elif len(parts) == 1:
                    path, label = parts[0], 0
                else:
                    raise RuntimeError(f"bad row: {line}")
                for idx in range(self._num_clips):
                    self._path_to_videos.append(
                        os.path.join(cfg.DATA.PATH_PREFIX, path)
                    )
                    self._labels.append(int(label))
                    self._spatial_temporal_idx.append(idx)
        if not self._path_to_videos:
            raise RuntimeError(f"empty split {path_to_file}")
        logger.info(
            "Constructed kinetics dataset (size %d) from %s",
            len(self._path_to_videos), path_to_file,
        )

    def _get_chunk(self, f, chunksize):
        """First ``chunksize`` rows after ``self.skip_rows``; wraps to the
        file start once when the skip runs past the end."""
        for _ in range(2):
            rows = []
            for i, line in enumerate(f):
                if i < self.skip_rows:
                    continue
                rows.append(line)
                if len(rows) >= chunksize:
                    break
            if rows:
                return rows
            self.skip_rows = 0
            f.seek(0)
        raise RuntimeError(
            f"{getattr(f, 'name', '<split file>')} yielded no rows "
            "(empty split file?)"
        )

    def _set_epoch_num(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self._path_to_videos)

    def _sample_params(self, index, short_cycle_idx=None):
        """(temporal_idx, spatial_idx, min_scale, max_scale, crop_size).
        Under multigrid a short cycle's phase (``short_cycle_idx`` 0 or 1)
        crops SHORT_CYCLE_FACTORS[phase] x DEFAULT_S, and the smaller scale
        follows the crop (x crop / DEFAULT_S), as in the JAX package
        (`kinetics.py:138-163`)."""
        cfg = self.cfg
        if self.mode in ["train", "val"]:
            temporal_idx = -1
            spatial_idx = cfg.TRAIN.SPATIAL_SAMPLE_INDEX
            min_scale = cfg.DATA.TRAIN_JITTER_SCALES[0]
            max_scale = cfg.DATA.TRAIN_JITTER_SCALES[1]
            crop_size = cfg.DATA.TRAIN_CROP_SIZE
            if short_cycle_idx in [0, 1] and cfg.MULTIGRID.SHORT_CYCLE:
                crop_size = int(round(
                    cfg.MULTIGRID.SHORT_CYCLE_FACTORS[short_cycle_idx] * cfg.MULTIGRID.DEFAULT_S))
            if cfg.MULTIGRID.DEFAULT_S > 0:
                min_scale = int(round(float(min_scale) * crop_size / cfg.MULTIGRID.DEFAULT_S))
        else:
            st_idx = self._spatial_temporal_idx[index]
            temporal_idx = st_idx // cfg.TEST.NUM_SPATIAL_CROPS
            spatial_idx = (
                st_idx % cfg.TEST.NUM_SPATIAL_CROPS
                if cfg.TEST.NUM_SPATIAL_CROPS > 1
                else (
                    cfg.TEST.SPATIAL_SAMPLE_INDEX
                    if cfg.TEST.SPATIAL_SAMPLE_INDEX in (-2, 0, 1, 2)
                    else 1
                )
            )
            # Multi-crop protocols resize the short side to the crop size;
            # the 1-crop protocol resizes to TRAIN_JITTER_SCALES[0] and
            # center-crops from the larger frame (`kinetics.py:244-250`).
            min_scale, max_scale = (
                [cfg.DATA.TEST_CROP_SIZE] * 2
                if cfg.TEST.NUM_SPATIAL_CROPS > 1
                else [cfg.DATA.TRAIN_JITTER_SCALES[0]] * 2
            )
            crop_size = cfg.DATA.TEST_CROP_SIZE
        return temporal_idx, spatial_idx, min_scale, max_scale, crop_size

    def __getitem__(self, index):
        short_cycle_idx = None
        if isinstance(index, tuple):  # (index, short-cycle phase) of the loader
            index, short_cycle_idx = index
        if self.cfg.DATA.DUMMY_LOAD and self.dummy_output is not None:
            return self.dummy_output
        rng = np.random.default_rng((self.cfg.RNG_SEED, self.epoch, index))
        params = self._sample_params(index, short_cycle_idx)
        for i_try in range(self._NUM_RETRIES):
            path = self._path_to_videos[index]
            try:
                reader = binding.VideoReader(path)
            except IOError as e:
                logger.warning("Failed to open %s: %s", path, e)
                reader = None
            frames = None
            if reader is not None:
                try:
                    frames, time_frac = self._decode_and_transform(
                        reader, *params, rng
                    )
                except Exception as e:
                    logger.warning("Failed to decode %s: %s", path, e)
                finally:
                    reader.close()
            if frames is None:
                if self.mode not in ["test"] and i_try > self._NUM_RETRIES // 8:
                    index = int(rng.integers(0, len(self._path_to_videos)))
                continue
            frames, pm = frames
            sample = {
                "frames": frames,  # uint8 [T, H, W, C]
                "label": self._labels[index],
                "index": index,
                "time": time_frac,
                "pm": pm,
            }
            if self.mode == "train" and self.cfg.AUG.GEN_MASK_LOADER:
                # Blockwise MaskFeat mask on the AUG.MASK_WINDOW_SIZE grid
                # (`kinetics.py:542-578` _gen_mask), the sample's last draw.
                sample["mask"] = masking.gen_mask(self.cfg, rng).reshape(-1).astype(bool)
            if self.cfg.DATA.DUMMY_LOAD and self.dummy_output is None:
                self.dummy_output = sample
            return sample
        raise RuntimeError(
            f"Failed to fetch video after {self._NUM_RETRIES} retries."
        )

    def _decode_and_transform(
        self, reader, temporal_idx, spatial_idx, min_scale, max_scale,
        crop_size, rng,
    ):
        """Decode one clip of ``reader`` and crop it: ((uint8 frames, pm),
        start fraction), every draw from ``rng`` (`kinetics.py:250-443` of
        the JAX package, draw for draw)."""
        cfg = self.cfg

        # Geometry decisions before decode (lets swscale do the resize).
        H, W = reader.height, reader.width
        is_test = self.mode == "test"
        switch_auto = (
            cfg.DATA.TEST_CROP_SIZE_RECT_SWITCH_AUTO
            if is_test
            else cfg.DATA.TRAIN_CROP_SIZE_RECT_SWITCH_AUTO
        )
        rect = (
            cfg.DATA.TEST_CROP_SIZE_RECT if is_test
            else cfg.DATA.TRAIN_CROP_SIZE_RECT
        )
        rect = list(rect) if len(rect) else None
        pm = False
        if rect is not None and switch_auto:
            if H > W:
                rect = rect[::-1]
                pm = True
        auto_adjust = (
            cfg.DATA.TEST_JITTER_SCALES_AUTO_ADJUST if is_test
            else cfg.DATA.TRAIN_JITTER_SCALES_AUTO_ADJUST
        )

        scl = list(cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE)
        asp = list(cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE)
        use_relative = self.mode == "train" and len(scl) and len(asp)

        # Short-side target for the in-decoder resize.
        if spatial_idx == -1:
            if rect is not None and auto_adjust:
                min_scale, max_scale = spatial.scale_adjust_short_side_scale_jitter(
                    min_scale, max_scale, rect, H, W
                )
            size = int(round(rng.uniform(min_scale, max_scale)))
        else:
            if rect is not None and auto_adjust:
                min_scale, max_scale = spatial.scale_adjust_short_side_scale_jitter(
                    min_scale, max_scale, rect, H, W
                )
                max_scale = min_scale
            size = min_scale
        out_h, out_w = video_decoder.jitter_scale_dims(H, W, size)

        # Multigrid long cycles raise the sampling rate randomly; fps
        # jitter perturbs the resampling target (`kinetics.py:349-351`).
        sampling_rate = cfg.DATA.SAMPLING_RATE
        if (
            self.mode == "train"
            and cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE > sampling_rate
        ):
            sampling_rate = int(
                rng.integers(
                    sampling_rate, cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE + 1
                )
            )
        target_fps = cfg.DATA.TARGET_FPS
        if self.mode == "train" and cfg.DATA.TRAIN_JITTER_FPS > 0.0:
            target_fps += float(rng.uniform(0.0, cfg.DATA.TRAIN_JITTER_FPS))
        # Contrastive multi-clip positives: V temporal windows a sample.
        num_temporal = cfg.DATA.TRAIN_CROP_NUM_TEMPORAL if self.mode == "train" else 1
        if num_temporal > 1:
            frames, fracs = video_decoder.decode_multi_clip(
                reader,
                sampling_rate,
                cfg.DATA.NUM_FRAMES,
                num_views=num_temporal,
                min_delta=cfg.CONTRASTIVE.DELTA_CLIPS_MIN,
                max_delta=cfg.CONTRASTIVE.DELTA_CLIPS_MAX,
                target_fps=target_fps,
                use_offset=cfg.DATA.USE_OFFSET_SAMPLING,
                out_w=out_w,
                out_h=out_h,
                rng=rng,
            )
            time_frac = float(fracs[0])
        else:
            frames, time_frac = video_decoder.decode_clip(
                reader,
                sampling_rate,
                cfg.DATA.NUM_FRAMES,
                clip_idx=temporal_idx,
                num_clips=(cfg.TEST.NUM_ENSEMBLE_VIEWS if is_test else 1),
                target_fps=target_fps,
                use_offset=cfg.DATA.USE_OFFSET_SAMPLING,
                out_w=out_w,
                out_h=out_h,
                rng=rng,
            )
        frames = frames.astype(np.float32)

        # Crop and flip (host, cheap).
        if spatial_idx == -1:
            def one_crop(fr):
                if use_relative:
                    th, tw = (
                        (crop_size, crop_size) if rect is None
                        else (rect[0], rect[1])
                    )
                    fr = transform.random_resized_crop(
                        fr, th, tw, scale=tuple(scl), ratio=tuple(asp),
                        switch_hw=True, rng=rng,
                    )
                elif rect is None:
                    fr = transform.random_crop(fr, crop_size, rng=rng)
                else:
                    fr = transform.random_crop_rect(fr, rect, rng=rng)
                if cfg.DATA.RANDOM_FLIP:
                    fr = transform.horizontal_flip(0.5, fr, rng=rng)
                return fr

            num_spatial = cfg.DATA.TRAIN_CROP_NUM_SPATIAL if self.mode == "train" else 1
            # Repeated augmentation (AUG.NUM_SAMPLE): decode once, crop and
            # flip each copy anew.
            num_aug = (
                cfg.AUG.NUM_SAMPLE
                if self.mode == "train" and cfg.AUG.ENABLE
                else 1
            )
            if num_temporal > 1 or num_spatial > 1:
                # Contrastive views: independent crops of each window, on a
                # leading view axis.
                clips = frames if num_temporal > 1 else [frames]
                frames = np.stack([one_crop(clip) for clip in clips for _ in range(num_spatial)])
            elif num_aug > 1:
                frames = np.stack([one_crop(frames) for _ in range(num_aug)])
            else:
                frames = one_crop(frames)
        elif spatial_idx == -2:
            ratio = list(
                cfg.TEST.SPATIAL_SAMPLE_RATIO if is_test
                else cfg.TRAIN.SPATIAL_SAMPLE_RATIO
            )
            new_h, new_w = frames.shape[1], frames.shape[2]
            off_h = min(max(math.ceil((new_h - crop_size) * ratio[0]), 0),
                        new_h - crop_size)
            off_w = min(max(math.ceil((new_w - crop_size) * ratio[1]), 0),
                        new_w - crop_size)
            frames = transform.specified_crop(
                frames, crop_size, center_ords=[off_w, off_h]
            )
        elif rect is None:
            frames = transform.uniform_crop(frames, crop_size, spatial_idx)
        else:
            frames = transform.uniform_crop_rect(frames, rect, spatial_idx)

        # Portrait -> landscape layout and the pm flag (axes from the end:
        # frames may carry a leading num_aug axis).
        if pm:
            frames = np.swapaxes(frames, -3, -2)

        frames = np.ascontiguousarray(np.clip(frames, 0, 255).astype(np.uint8))
        return (frames, pm), time_frac


# The reference also names the same data "ptvkinetics"
# (`MViT/slowfast/datasets/ptv_datasets.py:142`); here it is this dataset.
DATASET_REGISTRY.register(Kinetics, name="Ptvkinetics")
