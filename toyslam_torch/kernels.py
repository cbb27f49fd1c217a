"""Build and load the hand-written CUDA kernels of ``toyslam_torch/csrc``.

Each kernel source has a plain C interface.  At first use it is compiled
with ``nvcc`` for ``sm_90a`` (Hopper) into a shared library under
``toyslam_torch/_build/`` (not tracked) and loaded with ``ctypes``.  The
library file name carries a hash of the source and flags, so an edited
source is rebuilt and a cached one is reused.  Nothing here falls back:
a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math: the kernels rely on IEEE division and on isfinite()
# seeing NaN/inf (the PCG breakdown test).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an up-to-date library was reused
    ptxas_log: str         # nvcc -Xptxas -v output (registers, smem, spills)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of toyslam_torch are built "
            "from source at first use and need the CUDA toolkit"
        )
    return nvcc


@functools.cache
def load(name: str) -> KernelLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {src.name} "
                f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(
        lib=ctypes.CDLL(str(out)), path=out, build_seconds=seconds,
        ptxas_log=log,
    )
