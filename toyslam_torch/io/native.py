"""ctypes bridge to the native runtime (native/: libtoyslam_native.so).

The native library provides the wire codec, the framed-TCP server, the
thread pool, the phase timer, and a CPU Gauss-Newton optimizer
(native/include/toyslam/*.h).  This module loads it, mirrors the ``TsGraph``
struct of arrays, and converts to and from this package's
:class:`FactorGraph2D` (tensors on any device are read back to the host;
graphs built here are CPU tensors).

The library is built on demand with ``native/build.sh`` (plain g++) if the
shared object is missing.  Where that fails every entry point raises
``NativeUnavailable``, and the pure-Python server and codec still work.
"""

from __future__ import annotations

import ctypes as C
import dataclasses
import os
import subprocess
import threading
from typing import Callable, Optional

import numpy as np
import torch

from toyslam_torch.models.graph import (
    FactorGraph2D,
    GraphBuilder2D,
    to_numpy as _np,
)

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_LIB_PATHS = [
    os.environ.get("TOYSLAM_NATIVE_LIB", ""),
    os.path.join(_REPO_ROOT, "native", "build", "libtoyslam_native.so"),
]


class NativeUnavailable(RuntimeError):
    pass


class TsGraph(C.Structure):
    _fields_ = [
        ("n_poses", C.c_uint32),
        ("poses", C.POINTER(C.c_float)),
        ("pose_ids", C.POINTER(C.c_uint32)),
        ("n_landmarks", C.c_uint32),
        ("landmarks", C.POINTER(C.c_float)),
        ("lm_ids", C.POINTER(C.c_uint32)),
        ("n_odom", C.c_uint32),
        ("odom_i", C.POINTER(C.c_uint32)),
        ("odom_j", C.POINTER(C.c_uint32)),
        ("odom_meas", C.POINTER(C.c_float)),
        ("odom_info", C.POINTER(C.c_float)),
        ("n_lm_edges", C.c_uint32),
        ("lme_pose", C.POINTER(C.c_uint32)),
        ("lme_lm", C.POINTER(C.c_uint32)),
        ("lme_meas", C.POINTER(C.c_float)),
        ("lme_info", C.POINTER(C.c_float)),
        ("n_fixed", C.c_uint32),
        ("fixed_ids", C.POINTER(C.c_uint32)),
    ]


class TsOptimizeOptions(C.Structure):
    _fields_ = [
        ("iterations", C.c_int32),
        ("lr", C.c_float),
        ("huber_delta", C.c_float),
        ("lambda_init", C.c_float),
        ("lambda_min", C.c_float),
        ("lambda_max", C.c_float),
        ("lambda_factor", C.c_float),
        ("fixed_prior", C.c_float),
        ("convergence_eps", C.c_float),
        ("penalty_limit", C.c_int32),
        ("num_threads", C.c_int32),
    ]


class TsOptimizeStats(C.Structure):
    _fields_ = [
        ("iterations_run", C.c_int32),
        ("final_chi2", C.c_float),
        ("converged", C.c_int32),
        ("diverged", C.c_int32),
    ]


OPTIMIZE_CB = C.CFUNCTYPE(C.c_int, C.POINTER(TsGraph), C.c_void_p)

_lib = None
_lib_lock = threading.Lock()


def _try_build() -> None:
    script = os.path.join(_REPO_ROOT, "native", "build.sh")
    if not os.path.exists(script):
        return
    try:
        subprocess.run(
            ["sh", script], check=True, capture_output=True, timeout=300
        )
    except (subprocess.SubprocessError, OSError):
        pass


def load_library() -> C.CDLL:
    """Load (building on demand) the native shared object."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = next((p for p in _LIB_PATHS if p and os.path.exists(p)), None)
        if path is None:
            _try_build()
            path = next(
                (p for p in _LIB_PATHS if p and os.path.exists(p)), None
            )
        if path is None:
            raise NativeUnavailable(
                "libtoyslam_native.so not found and build failed; run "
                "native/build.sh"
            )
        lib = C.CDLL(path)
        lib.ts_graph_decode.restype = C.POINTER(TsGraph)
        lib.ts_graph_decode.argtypes = [C.c_char_p, C.c_uint64, C.c_int]
        lib.ts_graph_encode.restype = C.POINTER(C.c_uint8)
        lib.ts_graph_encode.argtypes = [
            C.POINTER(TsGraph),
            C.c_int,
            C.POINTER(C.c_uint64),
        ]
        lib.ts_graph_alloc.restype = C.POINTER(TsGraph)
        lib.ts_graph_alloc.argtypes = [C.c_uint32] * 5
        lib.ts_graph_free.argtypes = [C.POINTER(TsGraph)]
        lib.ts_buffer_free.argtypes = [C.POINTER(C.c_uint8)]
        lib.ts_optimize.restype = C.c_int
        lib.ts_optimize.argtypes = [
            C.POINTER(TsGraph),
            C.POINTER(TsOptimizeOptions),
            C.POINTER(TsOptimizeStats),
        ]
        lib.ts_optimize_options_default.argtypes = [
            C.POINTER(TsOptimizeOptions)
        ]
        lib.ts_set_verbose.argtypes = [C.c_int]
        lib.ts_timing_report.restype = C.c_uint64
        lib.ts_timing_report.argtypes = [C.c_char_p, C.c_uint64, C.c_int]
        lib.ts_server_create.restype = C.c_void_p
        lib.ts_server_create.argtypes = [
            C.c_char_p,
            C.c_uint16,
            OPTIMIZE_CB,
            C.c_void_p,
            C.c_int,
        ]
        lib.ts_server_port.restype = C.c_uint16
        lib.ts_server_port.argtypes = [C.c_void_p]
        lib.ts_server_run.argtypes = [C.c_void_p]
        lib.ts_server_stop.argtypes = [C.c_void_p]
        lib.ts_server_free.argtypes = [C.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    try:
        load_library()
        return True
    except NativeUnavailable:
        return False


# ---- TsGraph <-> numpy / FactorGraph2D -------------------------------------


def _as_np(ptr, count, dtype):
    if count == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(count,)).view(dtype)


def ts_view(g: "C.POINTER(TsGraph)") -> dict[str, np.ndarray]:
    """Zero-copy numpy views over a TsGraph's arrays."""
    s = g.contents
    return {
        "poses": _as_np(s.poses, 3 * s.n_poses, np.float32).reshape(-1, 3),
        "pose_ids": _as_np(s.pose_ids, s.n_poses, np.uint32),
        "landmarks": _as_np(
            s.landmarks, 2 * s.n_landmarks, np.float32
        ).reshape(-1, 2),
        "lm_ids": _as_np(s.lm_ids, s.n_landmarks, np.uint32),
        "odom_i": _as_np(s.odom_i, s.n_odom, np.uint32),
        "odom_j": _as_np(s.odom_j, s.n_odom, np.uint32),
        "odom_meas": _as_np(s.odom_meas, 3 * s.n_odom, np.float32).reshape(
            -1, 3
        ),
        "odom_info": _as_np(s.odom_info, 3 * s.n_odom, np.float32).reshape(
            -1, 3
        ),
        "lme_pose": _as_np(s.lme_pose, s.n_lm_edges, np.uint32),
        "lme_lm": _as_np(s.lme_lm, s.n_lm_edges, np.uint32),
        "lme_meas": _as_np(s.lme_meas, 2 * s.n_lm_edges, np.float32).reshape(
            -1, 2
        ),
        "lme_info": _as_np(s.lme_info, 2 * s.n_lm_edges, np.float32).reshape(
            -1, 2
        ),
        "fixed_ids": _as_np(s.fixed_ids, s.n_fixed, np.uint32),
    }


def graph_to_ts(graph: FactorGraph2D):
    """Allocate a TsGraph populated from the real (unpadded) entries."""
    lib = load_library()
    pose_mask = _np(graph.pose_mask) > 0.5
    lm_mask = _np(graph.lm_mask) > 0.5
    od_mask = _np(graph.odom.mask) > 0.5
    le_mask = _np(graph.lm_edges.mask) > 0.5
    n = int(pose_mask.sum())
    m = int(lm_mask.sum())
    n_padded = _np(graph.poses).shape[0]
    fixed_p = np.nonzero((_np(graph.pose_fixed) > 0.5) & pose_mask)[0]
    fixed_l = np.nonzero((_np(graph.lm_fixed) > 0.5) & lm_mask)[0]

    g = lib.ts_graph_alloc(
        n, m, int(od_mask.sum()), int(le_mask.sum()),
        len(fixed_p) + len(fixed_l),
    )
    v = ts_view(g)
    v["poses"][:] = _np(graph.poses)[pose_mask]
    v["pose_ids"][:] = np.nonzero(pose_mask)[0].astype(np.uint32)
    v["landmarks"][:] = _np(graph.landmarks)[lm_mask]
    v["lm_ids"][:] = (n_padded + np.nonzero(lm_mask)[0]).astype(np.uint32)
    v["odom_i"][:] = _np(graph.odom.i)[od_mask].astype(np.uint32)
    v["odom_j"][:] = _np(graph.odom.j)[od_mask].astype(np.uint32)
    v["odom_meas"][:] = _np(graph.odom.meas)[od_mask]
    v["odom_info"][:] = _np(graph.odom.info)[od_mask][
        :, (0, 1, 2), (0, 1, 2)
    ]
    v["lme_pose"][:] = _np(graph.lm_edges.pose)[le_mask].astype(
        np.uint32
    )
    v["lme_lm"][:] = _np(graph.lm_edges.lm)[le_mask].astype(np.uint32)
    v["lme_meas"][:] = _np(graph.lm_edges.meas)[le_mask]
    v["lme_info"][:] = _np(graph.lm_edges.info)[le_mask][
        :, (0, 1), (0, 1)
    ]
    v["fixed_ids"][:] = np.concatenate(
        [fixed_p, n_padded + fixed_l]
    ).astype(np.uint32)
    return g


def ts_to_graph(
    g,
    pose_bucket: int = 64,
    landmark_bucket: int = 64,
    edge_bucket: int = 256,
) -> FactorGraph2D:
    """Build a padded FactorGraph2D from a TsGraph (copies)."""
    v = ts_view(g)
    b = GraphBuilder2D(
        pose_bucket=pose_bucket,
        landmark_bucket=landmark_bucket,
        edge_bucket=edge_bucket,
    )
    fixed = set(int(x) for x in v["fixed_ids"])
    pose_ids = v["pose_ids"]
    for k in range(len(pose_ids)):
        b.add_pose(v["poses"][k], fixed=int(pose_ids[k]) in fixed)
    lm_ids = v["lm_ids"]
    for k in range(len(lm_ids)):
        b.add_landmark(
            int(lm_ids[k]), v["landmarks"][k],
            fixed=int(lm_ids[k]) in fixed,
        )
    for k in range(len(v["odom_i"])):
        b.add_odom_edge(
            int(v["odom_i"][k]),
            int(v["odom_j"][k]),
            v["odom_meas"][k],
            np.diag(v["odom_info"][k]),
        )
    for k in range(len(v["lme_pose"])):
        b.add_landmark_edge(
            int(v["lme_pose"][k]),
            int(lm_ids[v["lme_lm"][k]]),
            v["lme_meas"][k],
            np.diag(v["lme_info"][k]),
        )
    return b.build()


# ---- codec entry points ------------------------------------------------------


def native_encode(graph: FactorGraph2D, framed: bool = True) -> bytes:
    lib = load_library()
    g = graph_to_ts(graph)
    try:
        out_len = C.c_uint64()
        buf = lib.ts_graph_encode(g, int(framed), C.byref(out_len))
        try:
            return C.string_at(buf, out_len.value)
        finally:
            lib.ts_buffer_free(buf)
    finally:
        lib.ts_graph_free(g)


def native_decode(data: bytes, framed: bool = True, **buckets) -> FactorGraph2D:
    lib = load_library()
    g = lib.ts_graph_decode(data, len(data), int(framed))
    if not g:
        raise ValueError("native decode failed: malformed stream")
    try:
        return ts_to_graph(g, **buckets)
    finally:
        lib.ts_graph_free(g)


def native_optimize(
    graph: FactorGraph2D, **options
) -> tuple[FactorGraph2D, TsOptimizeStats]:
    """Run the native CPU Gauss-Newton backend on a graph."""
    lib = load_library()
    opts = TsOptimizeOptions()
    lib.ts_optimize_options_default(C.byref(opts))
    for key, value in options.items():
        setattr(opts, key, value)
    stats = TsOptimizeStats()
    g = graph_to_ts(graph)
    try:
        rc = lib.ts_optimize(g, C.byref(opts), C.byref(stats))
        if rc != 0:
            raise RuntimeError("native optimizer failed (singular system)")
        v = ts_view(g)
        poses = _np(graph.poses).copy()
        lms = _np(graph.landmarks).copy()
        poses[_np(graph.pose_mask) > 0.5] = v["poses"]
        lms[_np(graph.lm_mask) > 0.5] = v["landmarks"]
        return (
            dataclasses.replace(
                graph,
                poses=torch.from_numpy(poses).to(graph.device),
                landmarks=torch.from_numpy(lms).to(graph.device),
            ),
            stats,
        )
    finally:
        lib.ts_graph_free(g)


def timing_report(clear: bool = False) -> dict[str, tuple[int, float]]:
    """Native phase timings: {caption: (count, total_ms)}."""
    lib = load_library()
    needed = lib.ts_timing_report(None, 0, 0)
    buf = C.create_string_buffer(int(needed) + 1)
    lib.ts_timing_report(buf, len(buf), int(clear))
    out = {}
    for line in buf.value.decode().splitlines():
        caption, count, ms = line.rsplit(":", 2)
        out[caption] = (int(count), float(ms))
    return out


# ---- embedded server ---------------------------------------------------------


class NativeServer:
    """The native TCP server with a Python optimize callback.

    ``optimize_fn(graph) -> graph`` runs in a native pool thread (ctypes
    re-acquires the GIL) on a graph of CPU tensors; pass ``None`` to serve
    with the built-in native CPU optimizer instead, with no Python on the
    request path.  An exception in the callback is kept in ``error`` and
    fails that request.
    """

    def __init__(
        self,
        optimize_fn: Optional[Callable[[FactorGraph2D], FactorGraph2D]],
        host: str = "127.0.0.1",
        port: int = 0,
        num_threads: int = 4,
    ):
        lib = load_library()
        self._lib = lib
        self.optimize_fn = optimize_fn
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

        if optimize_fn is None:
            self._cb = OPTIMIZE_CB()  # NULL -> native built-in optimizer
        else:
            def _cb(g_ptr, _user):
                try:
                    graph = ts_to_graph(g_ptr)
                    result = self.optimize_fn(graph)
                    v = ts_view(g_ptr)
                    v["poses"][:] = _np(result.poses)[
                        _np(result.pose_mask) > 0.5
                    ]
                    v["landmarks"][:] = _np(result.landmarks)[
                        _np(result.lm_mask) > 0.5
                    ]
                    return 0
                except BaseException as exc:  # noqa: BLE001
                    self.error = exc
                    return 1

            self._cb = OPTIMIZE_CB(_cb)

        self._handle = lib.ts_server_create(
            host.encode(), port, self._cb, None, num_threads
        )
        if not self._handle:
            raise OSError(f"cannot bind {host}:{port}")

    @property
    def port(self) -> int:
        return int(self._lib.ts_server_port(self._handle))

    def start(self) -> "NativeServer":
        self._thread = threading.Thread(
            target=self._lib.ts_server_run,
            args=(self._handle,),
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._handle:
            self._lib.ts_server_stop(self._handle)
            if self._thread is not None:
                self._thread.join(timeout=10)
            self._lib.ts_server_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
