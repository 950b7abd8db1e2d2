"""Log-mel audio features (`pmv_tpu/data/audio.py`, the port's own copy).

numpy, as the JAX package computes them (the reference's librosa pipeline,
`MViT/slowfast/datasets/decoder_av.py:200-215` gen_logmel): a hann-windowed
STFT (center=False), an HTK mel filterbank, the log power, per-clip
z-normalization, then zero rows padded, or rows cut, to a fixed frame count
(DATA.AUDIO_FRAME_NUM), so that every clip has one shape. The defaults are
the AVSlowFast config's: 16 kHz, a 32 ms window, a 16 ms step, 40 mel bins.
"""

import numpy as np


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr, n_fft, n_mels, fmin=0.0, fmax=None):
    """HTK mel filterbank [n_mels, n_fft // 2 + 1] (librosa htk=True)."""
    fmax = fmax or sr / 2.0
    fft_freqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel_htk(fmin), hz_to_mel_htk(fmax), n_mels + 2)
    hz_pts = mel_to_hz_htk(mel_pts)
    fb = np.zeros((n_mels, len(fft_freqs)), np.float64)
    for i in range(n_mels):
        lower, center, upper = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lower) / max(center - lower, 1e-10)
        down = (upper - fft_freqs) / max(upper - center, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


def stft_power(y, n_fft, hop):
    """|STFT|^2 with a hann window, center=False -> [frames, n_fft // 2 + 1];
    a waveform shorter than the window is zero-padded to one frame."""
    y = np.asarray(y, np.float32)
    if len(y) < n_fft:
        y = np.pad(y, (0, n_fft - len(y)))
    n_frames = 1 + (len(y) - n_fft) // hop
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    spec = np.fft.rfft(y[idx] * window, n=n_fft, axis=1)
    return (spec.real ** 2 + spec.imag ** 2).astype(np.float32)


def gen_logmel(y, sr=16000, win_sz_ms=32, step_sz_ms=16, n_mels=40, num_frames=None,
               normalize=True):
    """waveform -> log-mel [frames, n_mels] float32; with ``num_frames`` the
    rows zero-padded or cut to that count."""
    n_fft = int(sr * win_sz_ms / 1000)
    hop = int(sr * step_sz_ms / 1000)
    mel = stft_power(y, n_fft, hop) @ mel_filterbank(sr, n_fft, n_mels).T
    logmel = np.log(mel + 1e-6)
    if normalize:
        logmel = (logmel - logmel.mean()) / (logmel.std() + 1e-5)
    if num_frames is not None:
        if logmel.shape[0] < num_frames:
            logmel = np.pad(logmel, ((0, num_frames - logmel.shape[0]), (0, 0)))
        else:
            logmel = logmel[:num_frames]
    return logmel.astype(np.float32)
