"""Build and load the hand-written CUDA kernels of ``toyslam_torch/csrc``.

Each kernel source has a plain C interface.  At first use it is compiled
with ``nvcc`` for ``sm_90a`` (Hopper) into a shared library under
``toyslam_torch/_build/`` (not tracked) and loaded with ``ctypes``.  The
library file name carries a hash of the source and flags, so an edited
source is rebuilt and a cached one is reused.  :func:`load_all` builds
several sources at once, one ``nvcc`` process each.  Nothing here falls
back: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
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


KERNELS = ("fused_pcg_chunk", "band_fused_pcg_chunk", "slab_band_matvec")

_loaded: dict[str, KernelLibrary] = {}


def _library_path(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def load_all(names=KERNELS) -> dict[str, KernelLibrary]:
    """Build the missing libraries of ``names`` (one ``nvcc`` each, all
    started together) and load them."""
    builds = {}
    for name in names:
        src, out = _library_path(name)
        if name in _loaded or out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        builds[name] = (proc, tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, t0) in builds.items():
        log = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _loaded:
            _, out = _library_path(name)
            log_path = out.with_suffix(".log")
            _loaded[name] = KernelLibrary(
                lib=ctypes.CDLL(str(out)), path=out,
                build_seconds=seconds.get(name, 0.0),
                ptxas_log=log_path.read_text() if log_path.exists() else "",
            )
    return {name: _loaded[name] for name in names}


def load(name: str) -> KernelLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return load_all((name,))[name]
