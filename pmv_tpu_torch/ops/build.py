"""Build and load the package's hand-written CUDA kernels.

Each source in ``ops/csrc/*.cu`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, which the
kernel's wrapper loads with ``ctypes``. A library is named after a hash of
its source and the compiler flags, so an edited source never loads a stale
build. Building happens at first use, never at import; ``build_kernels``
starts one ``nvcc`` per source, all at once, and waits for them together.

The libraries go to ``build/kernels`` at the root of the checkout (listed in
``.gitignore``), or to ``$PMV_TORCH_BUILD_DIR`` when that is set.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded = {}  # source stem -> ctypes.CDLL
build_log = {}  # source stem -> nvcc's output (ptxas register/spill report)


def build_dir():
    env = os.environ.get("PMV_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def nvcc_path():
    """nvcc on PATH, else under CUDA_HOME as torch.utils.cpp_extension finds it."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME); the CUDA kernels cannot be built"
    )


def library_path(stem):
    src = CSRC / f"{stem}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return build_dir() / f"lib{stem}_{digest}.so"


def build_kernels(stems=None):
    """Compile every kernel source not built yet, in parallel. Returns the
    wall seconds spent. Raises with nvcc's output if a build fails."""
    stems = stems or sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [s for s in stems if not library_path(s).exists()]
    start = time.perf_counter()
    if not todo:
        return 0.0
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for stem in todo:
        tmp = out_dir / f".{library_path(stem).name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for stem, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        build_log[stem] = output
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(stem))  # atomic: never a half file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - start


def load_library(stem):
    """The ctypes handle of one kernel library, built on first use."""
    lib = _loaded.get(stem)
    if lib is None:
        build_kernels([stem])
        lib = ctypes.CDLL(str(library_path(stem)))
        _loaded[stem] = lib
    return lib
