"""Build and load the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``vivqa_tpu_torch/_build/`` (listed in ``.gitignore``) on first use, then
loaded with ``ctypes``. The library's file name carries a hash of the
source and flags, so an edited source is rebuilt and a stale library is
never loaded. Nothing here runs at import time: a host without ``nvcc``
imports this module and only fails when it asks for a kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    library: Path
    seconds: float      # 0.0 when the library was already built
    report: str         # nvcc's output, with ptxas' registers and smem


_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels build only on a host with the "
            "CUDA toolkit")
    return found


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    library = BUILD_DIR / f"lib{name}-{digest}.so"
    log = library.with_suffix(".log")
    if library.is_file():
        return BuildResult(library, 0.0,
                           log.read_text() if log.is_file() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=900)
        seconds = time.perf_counter() - t0
        report = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {source.name} (rc {res.returncode}):\n"
                f"{' '.join(cmd)}\n{report}")
        log.write_text(report)
        os.replace(tmp, library)   # atomic: a reader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return BuildResult(library, seconds, report)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name).library))
            _loaded[name] = lib
        return lib
