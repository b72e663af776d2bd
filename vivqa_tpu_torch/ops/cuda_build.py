"""Build and load the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) in parts (``PARTS``), into a shared
library under
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
# Sources built in parts: the kernel parts each source defines (its
# VIVQA_BUILDS_PART blocks, by dtype and head dim), besides part 0, the
# entry points. nvcc compiles every part at once and links them into the
# one library, so the longest part, not the whole source, sets the build's
# time. A source not named here builds as one translation unit.
PARTS = {"flash_attn_fwd": 13, "flash_attn_bwd": 6, "flash_attn_bwd_dq": 3,
         "flash_attn_bwd_dkv": 3}


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
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    The library's name hashes the source, every shared header
    (``csrc/*.cuh``) and the flags."""
    source = CSRC_DIR / f"{name}.cu"
    n_parts = PARTS[name]
    parts = [source.read_bytes(), " ".join(NVCC_FLAGS).encode(),
             str(n_parts).encode()]
    parts += [h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]
    library = BUILD_DIR / f"lib{name}-{digest}.so"
    log = library.with_suffix(".log")
    if library.is_file():
        return BuildResult(library, 0.0,
                           log.read_text() if log.is_file() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objs:
        try:
            compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
            objects = [f"{objs}/part{i}.o" for i in range(n_parts + 1)]
            report = _run_all(
                [[nvcc, *compile_flags, "-c", f"-DVIVQA_PART={i}", "-o",
                  obj, str(source)] for i, obj in enumerate(objects)],
                source.name)
            # a pair no part defines fails here, not at load time
            report += _run_all([[nvcc, "-shared", "-Xlinker", "--no-undefined",
                                 "-o", tmp, *objects]], source.name)
            seconds = time.perf_counter() - t0
            log.write_text(report)
            os.replace(tmp, library)   # atomic: a reader sees all or nothing
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return BuildResult(library, seconds, report)


def _run_all(cmds: list, source: str) -> str:
    """Run the commands at once; their output, in order. Raises with the
    first failure's command and output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate(timeout=900)[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} (rc "
                               f"{proc.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name).library))
            _loaded[name] = lib
        return lib
