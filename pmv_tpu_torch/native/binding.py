"""ctypes binding of the port's FFmpeg decode library.

The library is built from ``video_decoder.cpp`` beside this file (the port's
own copy of the JAX package's source) with ``g++`` and ``pkg-config``'s
FFmpeg flags, on first use, into ``build/native/`` at the root of the
checkout (listed in ``.gitignore``). Its name carries a hash of the source
and the flags, so an edited source never loads a stale build. Nothing falls
back: without the compiler or FFmpeg's development files, ``get_lib``
raises. Decode calls release the GIL, so a thread pool decodes in parallel.
"""

import ctypes
import hashlib
import os
import shlex
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "video_decoder.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
FFMPEG_LIBS = ("libavformat", "libavcodec", "libswscale", "libswresample", "libavutil")

_LOCK = threading.Lock()
_LIB = None


def library_path():
    """The library built from ``SOURCE``, under ``build/native/``."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    root = Path(__file__).resolve().parents[2]
    return root / "build" / "native" / f"libpmv_decoder_{digest.hexdigest()[:16]}.so"


def _build(path):
    try:
        flags = subprocess.run(
            ["pkg-config", "--cflags", "--libs", *FFMPEG_LIBS],
            check=True, capture_output=True, text=True,
        ).stdout
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        raise RuntimeError(
            f"FFmpeg's development files are not found by pkg-config: "
            f"{getattr(e, 'stderr', e)}"
        ) from e
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *shlex.split(flags)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"decoder build failed:\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent reader never sees half a file


def get_lib():
    """The decode library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.pmv_open.restype = ctypes.c_void_p
        lib.pmv_open.argtypes = [ctypes.c_char_p]
        lib.pmv_info.restype = ctypes.c_int
        lib.pmv_info.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.pmv_decode_frames.restype = ctypes.c_int
        lib.pmv_decode_frames.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.pmv_close.restype = None
        lib.pmv_close.argtypes = [ctypes.c_void_p]
        lib.pmv_write_test_video.restype = ctypes.c_int
        lib.pmv_write_test_video.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.pmv_decode_audio.restype = ctypes.c_longlong
        lib.pmv_decode_audio.argtypes = [
            ctypes.c_void_p,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
        ]
        lib.pmv_write_test_video_av.restype = ctypes.c_int
        lib.pmv_write_test_video_av.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
            ctypes.c_int,
        ]
        _LIB = lib
        return lib


class VideoReader:
    """One open container. Not thread-safe; use one per decode thread."""

    def __init__(self, path):
        lib = get_lib()
        self._lib = lib
        self._handle = lib.pmv_open(str(path).encode())
        if not self._handle:
            raise IOError(f"failed to open video: {path}")
        fps = ctypes.c_double()
        nb = ctypes.c_longlong()
        w = ctypes.c_int()
        h = ctypes.c_int()
        dur = ctypes.c_double()
        lib.pmv_info(
            self._handle, ctypes.byref(fps), ctypes.byref(nb),
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(dur),
        )
        self.fps = fps.value
        self.num_frames = int(nb.value)
        self.width = w.value
        self.height = h.value
        self.duration = dur.value

    def read_frames(self, indices, out_w=None, out_h=None):
        """Decode frames at ``indices`` -> uint8 [N, out_h, out_w, 3]; the
        native frame size by default."""
        out_w = out_w or self.width
        out_h = out_h or self.height
        indices = np.ascontiguousarray(np.sort(np.asarray(indices, np.int64)))
        n = len(indices)
        out = np.empty((n, out_h, out_w, 3), np.uint8)
        got = self._lib.pmv_decode_frames(
            self._handle,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            out_w,
            out_h,
        )
        if got <= 0:
            raise IOError(f"decode failed (code {got})")
        return out

    def read_audio(self, start_sec, dur_sec, sample_rate=16000):
        """Decode the audio over [start_sec, start_sec + dur_sec), resampled
        to mono float32 at ``sample_rate`` -> [N]; an empty array when the
        container has no audio stream."""
        max_samples = int(dur_sec * sample_rate) + sample_rate
        out = np.zeros((max_samples,), np.float32)
        got = self._lib.pmv_decode_audio(
            self._handle, float(start_sec), float(dur_sec), int(sample_rate),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_samples,
        )
        if got < 0:
            raise IOError(f"audio decode failed (code {got})")
        return out[:got]

    def close(self):
        if self._handle:
            self._lib.pmv_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_test_video(path, frames, fps=30, audio=None, audio_sr=16000):
    """Write uint8 [T, H, W, 3] RGB frames as an uncompressed AVI; with
    ``audio`` (float32 mono samples at ``audio_sr``) a PCM track beside
    them."""
    lib = get_lib()
    frames = np.ascontiguousarray(frames, np.uint8)
    t, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"frames must be RGB [T, H, W, 3], got {frames.shape}")
    pixels = frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
    if audio is None:
        rc = lib.pmv_write_test_video(str(path).encode(), pixels, t, w, h, fps)
    else:
        audio = np.ascontiguousarray(audio, np.float32)
        rc = lib.pmv_write_test_video_av(
            str(path).encode(), pixels, t, w, h, fps,
            audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(audio), audio_sr,
        )
    if rc != 0:
        raise IOError(f"write_test_video failed (code {rc})")
