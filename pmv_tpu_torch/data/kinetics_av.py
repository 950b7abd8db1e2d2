"""Audio-visual Kinetics (`pmv_tpu/data/kinetics_av.py`,
`MViT/slowfast/datasets/kinetics_av.py`), registered "Kinetics_av": the name
``build_dataset``'s capitalized lookup finds for TRAIN.DATASET kinetics_av.

A ``Kinetics`` sample, plus the log-mel of the audio under its clip
(``data/audio.gen_logmel``, DATA.AUDIO_FRAME_NUM x AUDIO_MEL_NUM), decoded by
the port's own library (``native.binding.VideoReader.read_audio``): the
window of the clip's duration (NUM_FRAMES x SAMPLING_RATE frames at the
video's rate, else DATA.TARGET_FPS) that starts at the sample's ``time``
fraction of the video's slack. With DATA.GET_MISALIGNED_AUDIO also
"audio_mis", the window AUDIO_MISALIGNED_GAP x AUDIO_STEP_SZ ms after it,
or before it when the video ends first (the AVS sync loss's negative).

A failed audio decode, like a video with no audio stream, gives an empty
waveform (logged as a warning for a failure), which ``gen_logmel`` pads, as
in the JAX package; a failed decode gives no "audio_mis" either, as there.

Under TPU.SHARD_STRATEGY dp_sp every rank of a model group loads the same
rows (``loader.construct_loader``, by the rank's data index) and keeps the
whole audio of each: the step cuts the frames to the rank's planes, and
the audio pathway runs whole on every rank (``models/avslowfast.py``).
"""

import numpy as np

from pmv_tpu_torch.data import audio as audio_lib
from pmv_tpu_torch.data.build import DATASET_REGISTRY
from pmv_tpu_torch.data.kinetics import Kinetics
from pmv_tpu_torch.native import binding
from pmv_tpu_torch.utils import logging as pmv_logging

logger = pmv_logging.get_logger(__name__)


def audio_windows(cfg, time_frac, fps, duration):
    """(start, misaligned start or None, window) in seconds of a clip at
    ``time_frac`` of a video of ``duration`` s at ``fps`` (`kinetics_av.py:
    22-45` of the JAX package)."""
    window = cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE / (
        fps if fps > 0 else cfg.DATA.TARGET_FPS)
    start = time_frac * max(duration - window, 0.0)
    if not cfg.DATA.GET_MISALIGNED_AUDIO:
        return start, None, window
    gap = cfg.DATA.AUDIO_MISALIGNED_GAP * cfg.DATA.AUDIO_STEP_SZ / 1000.0
    mis_start = start + window + gap
    if mis_start + window > duration:
        mis_start = max(start - window - gap, 0.0)
    return start, mis_start, window


def logmel(cfg, wav):
    """The log-mel features of ``wav`` at the config's audio settings."""
    return audio_lib.gen_logmel(
        wav, sr=cfg.DATA.AUDIO_SAMPLE_RATE, win_sz_ms=cfg.DATA.AUDIO_WIN_SZ,
        step_sz_ms=cfg.DATA.AUDIO_STEP_SZ, n_mels=cfg.DATA.AUDIO_MEL_NUM,
        num_frames=cfg.DATA.AUDIO_FRAME_NUM,
    )


@DATASET_REGISTRY.register(name="Kinetics_av")
class KineticsAV(Kinetics):
    def __getitem__(self, index):
        sample = super().__getitem__(index)
        cfg = self.cfg
        path = self._path_to_videos[sample["index"]]
        sr = cfg.DATA.AUDIO_SAMPLE_RATE
        try:
            with binding.VideoReader(path) as reader:
                start, mis_start, window = audio_windows(
                    cfg, sample["time"], reader.fps, reader.duration)
                wav = reader.read_audio(start, window, sr)
                wav_mis = None if mis_start is None else reader.read_audio(mis_start, window, sr)
        except Exception as e:
            logger.warning("audio decode failed for %s: %s", path, e)
            wav, wav_mis = np.zeros((0,), np.float32), None
        sample["audio"] = logmel(cfg, wav)
        if wav_mis is not None:
            sample["audio_mis"] = logmel(cfg, wav_mis)
        return sample
