"""The port's audio data path against the JAX package's.

- ``data/audio.py`` (the port's own copy of the numpy log-mel pipeline):
  ``mel_filterbank``, ``stft_power`` and ``gen_logmel`` equal to JAX's on
  waveforms drawn from a seed, a waveform shorter than the window and one
  longer than AUDIO_FRAME_NUM frames among them.
- The decode library's audio (``native.binding``): ``read_audio`` of the
  port's binding against JAX's on AVI files with a PCM track that the
  port's writer writes (the same samples, bit for bit); a video with no
  audio stream gives 0 samples.
- ``KineticsAV`` against JAX's on such files: frames, "audio" and
  "audio_mis" equal in test mode, and in train mode under one generator
  (the JAX dataset draws from an unseeded ``default_rng()``; the test hands
  it the port's seeded one); the misaligned window lies after the clip, or
  before it where the video ends first; a video without audio gives the
  padded log-mel of no samples; the loader's batches carry both clips.
"""

import numpy as np
import pytest

import pmv_tpu.data  # noqa: F401  (registers the JAX datasets)
from pmv_tpu.config import get_cfg as jax_get_cfg
from pmv_tpu.data import audio as jaudio
from pmv_tpu.data import kinetics as jkinetics
from pmv_tpu.data.build import build_dataset as jax_build_dataset
from pmv_tpu.native import binding as jbinding
from pmv_tpu_torch.data import audio, kinetics_av, loader
from pmv_tpu_torch.data.build import build_dataset
from pmv_tpu_torch.native import binding
from torch_port_util import port_cfg

SR = 16000


def _waveform(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tone = np.sin(2 * np.pi * (200 + 600 * t) * t)  # a chirp, so that windows differ
    return (0.3 * tone + 0.05 * rng.normal(size=t.shape)).astype(np.float32)


@pytest.mark.parametrize("n_fft, n_mels", [(512, 40), (512, 80), (400, 16)])
def test_mel_filterbank_matches_jax(n_fft, n_mels):
    np.testing.assert_array_equal(audio.mel_filterbank(SR, n_fft, n_mels),
                                  jaudio.mel_filterbank(SR, n_fft, n_mels))


@pytest.mark.parametrize("samples", [300, 4000, 40000])
def test_stft_power_and_logmel_match_jax(samples):
    y = _waveform(samples / SR, samples)
    np.testing.assert_array_equal(audio.stft_power(y, 512, 256), jaudio.stft_power(y, 512, 256))
    for frames, mels in ((None, 40), (128, 80), (64, 16)):
        got = audio.gen_logmel(y, n_mels=mels, num_frames=frames)
        np.testing.assert_array_equal(got, jaudio.gen_logmel(y, n_mels=mels, num_frames=frames))
        if frames is not None:
            assert got.shape == (frames, mels) and got.dtype == np.float32


# (height, width, seconds of audio, or None for no audio stream)
VIDEOS = [(48, 64, 2.0), (64, 48, 2.0), (48, 48, None)]
FPS = 15


@pytest.fixture(scope="module")
def av_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("av")
    vids = root / "videos"
    vids.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i, (h, w, seconds) in enumerate(VIDEOS):
        frames = rng.integers(0, 256, (30, h, w, 3), np.uint8)
        wav = None if seconds is None else _waveform(seconds, i)
        binding.write_test_video(vids / f"v{i}.avi", frames, fps=FPS, audio=wav, audio_sr=SR)
        rows.append(f"v{i}.avi,{i % 2}")
    for mode in ("train", "val", "test"):
        (root / f"{mode}.csv").write_text("\n".join(rows) + "\n")
    return root


def test_read_audio_matches_jax(av_data):
    for i, (_, _, seconds) in enumerate(VIDEOS):
        path = av_data / "videos" / f"v{i}.avi"
        with binding.VideoReader(path) as ours, jbinding.VideoReader(path) as ref:
            for start, dur in ((0.0, 0.5), (0.7, 0.6), (1.6, 1.0)):
                got = ours.read_audio(start, dur, SR)
                np.testing.assert_array_equal(got, ref.read_audio(start, dur, SR))
                if seconds is None:
                    assert got.shape == (0,)  # no audio stream: no samples
                else:
                    assert got.dtype == np.float32 and 0 < len(got) <= int(dur * SR) + SR
            if seconds is not None:  # the written samples, through 16-bit PCM
                got = ours.read_audio(0.0, 0.5, SR)
                np.testing.assert_allclose(got[:4000], _waveform(seconds, i)[:4000],
                                           atol=2 / 32768)


def _av_cfg(root, **overrides):
    cfg = jax_get_cfg()
    cfg.DATA.PATH_TO_DATA_DIR = str(root)
    cfg.DATA.PATH_PREFIX = str(root / "videos")
    cfg.DATA.PATH_LABEL_SEPARATOR = ","
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.SAMPLING_RATE = 2
    cfg.DATA.TRAIN_JITTER_SCALES = [40, 56]
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.AUDIO_FRAME_NUM = 64
    cfg.DATA.AUDIO_MEL_NUM = 16
    cfg.DATA.GET_MISALIGNED_AUDIO = True
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    cfg.MODEL.NUM_CLASSES = 2
    for key, value in overrides.items():
        node = cfg
        *path, leaf = key.split(".")
        for name in path:
            node = getattr(node, name)
        setattr(node, leaf, value)
    return cfg


def _assert_samples_equal(a, b):
    assert a.keys() == b.keys()
    assert (a["label"], a["index"], a["pm"], a["time"]) == (b["label"], b["index"], b["pm"],
                                                            b["time"])
    for key in ("frames", "audio", "audio_mis"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_kinetics_av_test_mode_matches_jax(av_data):
    cfg = _av_cfg(av_data)
    ours = build_dataset("kinetics_av", port_cfg(cfg), "test")
    ref = jax_build_dataset("kinetics_av", cfg, "test")
    assert type(ours).__name__ == "KineticsAV" and len(ours) == len(ref) == 2 * len(VIDEOS)
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        _assert_samples_equal(a, b)
        assert a["audio"].shape == a["audio_mis"].shape == (64, 16)
        assert a["audio"].dtype == np.float32
    # No audio stream: the padded log-mel of no samples, as gen_logmel pads it.
    silent = ours[2 * 2]
    np.testing.assert_array_equal(silent["audio"], audio.gen_logmel(
        np.zeros(0, np.float32), n_mels=16, num_frames=64))


def test_kinetics_av_train_mode_matches_jax_under_one_generator(av_data, monkeypatch):
    """The JAX dataset draws from an unseeded ``default_rng()``; here it gets
    the generator the port's seeds with (RNG_SEED, epoch, index)."""
    cfg = _av_cfg(av_data)
    ours = build_dataset("kinetics_av", port_cfg(cfg), "train")
    ref = jax_build_dataset("kinetics_av", cfg, "train")
    default_rng = np.random.default_rng
    index = {}

    def seeded(*args):
        return default_rng(*args) if args else default_rng((cfg.RNG_SEED, 0, index["i"]))

    monkeypatch.setattr(jkinetics.np.random, "default_rng", seeded)
    times = []
    for i in range(len(VIDEOS)):
        index["i"] = i
        a, b = ours[i], ref[i]
        _assert_samples_equal(a, b)
        times.append(a["time"])
    assert len(set(times)) == len(times)  # the clips lie at different times


def test_misaligned_window_moves_before_the_clip_at_the_end(av_data):
    """After the clip by AUDIO_MISALIGNED_GAP x AUDIO_STEP_SZ ms; before it
    when the window after would pass the video's end."""
    cfg = port_cfg(_av_cfg(av_data))
    window = 4 * 2 / FPS
    gap = 32 * 16 / 1000.0
    start, mis, w = kinetics_av.audio_windows(cfg, 0.0, FPS, 2.0)
    assert (start, w) == (0.0, window) and mis == pytest.approx(window + gap)
    start, mis, _ = kinetics_av.audio_windows(cfg, 1.0, FPS, 2.0)
    assert start == pytest.approx(2.0 - window) and mis == pytest.approx(start - window - gap)
    cfg.DATA.GET_MISALIGNED_AUDIO = False
    assert kinetics_av.audio_windows(cfg, 0.5, FPS, 2.0)[1] is None
    # The second test view of video 0 starts half-way: the window after it
    # would pass the end, so its misaligned clip is the log-mel of the window
    # before it (cut at the video's start).
    cfg.DATA.GET_MISALIGNED_AUDIO = True
    ds = build_dataset("kinetics_av", cfg, "test")
    last = ds[1]
    assert last["time"] == 0.5
    with binding.VideoReader(av_data / "videos" / "v0.avi") as reader:
        start, mis, w = kinetics_av.audio_windows(cfg, 0.5, reader.fps, reader.duration)
        assert start + 2 * w + gap > reader.duration and mis == max(start - w - gap, 0.0)
        want = kinetics_av.logmel(cfg, reader.read_audio(mis, w, SR))
    np.testing.assert_array_equal(last["audio_mis"], want)
    assert not np.array_equal(last["audio_mis"], last["audio"])


def test_loader_batches_carry_the_audio(av_data):
    cfg = port_cfg(_av_cfg(av_data))
    ds = build_dataset("kinetics_av", cfg, "test")
    batches = list(loader.DataLoader(ds, 4, num_workers=2))
    assert [b["audio"].shape for b in batches] == [(4, 64, 16), (2, 64, 16)]
    for key in ("audio", "audio_mis"):
        np.testing.assert_array_equal(np.concatenate([b[key] for b in batches]),
                                      np.stack([ds[i][key] for i in range(len(ds))]))
