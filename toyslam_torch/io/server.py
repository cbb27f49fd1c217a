"""Graph optimization servers.

Two interchangeable servers speak the framed graph protocol (io/codec.py):

* :func:`native_server`: the C++ runtime (native/src/server.cpp: POSIX
  sockets, thread pool, native codec) with the optimizer pluggable per
  backend:

  - ``backend="torch"``: this package's Gauss-Newton as the optimize
    callback: native transport and codec, the solve on ``device``;
  - ``backend="native"``: no Python on the request path, the built-in C++
    CPU Gauss-Newton (native/src/optimizer.cpp).

* :class:`PyGraphServer`: pure asyncio, for hosts without the native
  library and as a reference implementation of the protocol.

Both are stateless per request.  Both call the optimize callback off the
main thread (an executor thread here, a native pool thread there), so two
clients can reach it at once; :func:`torch_optimize_fn` serialises them.
An exception in the callback is kept in ``server.error`` and the connection
that hit it is closed without an answer.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import struct
import threading
import time
from typing import Callable, Optional

import torch

from toyslam_torch import tracing
from toyslam_torch.config import OptimizerConfig
from toyslam_torch.io import codec
from toyslam_torch.models.graph import FactorGraph2D

OptimizeFn = Callable[[FactorGraph2D], FactorGraph2D]

# requests whose host timings torch_optimize_fn keeps
TIMINGS_KEPT = 1024


def torch_optimize_fn(
    cfg: Optional[OptimizerConfig] = None, device="cuda"
) -> OptimizeFn:
    """``GaussNewton.optimize`` on ``device`` as a server callback.

    The decoded graph (CPU tensors, no gather plan) moves to ``device``,
    is laid out and optimized there, and the optimized poses and landmarks
    come back on the host in the request's own graph.

    One lock serialises the solves of this callback.  The servers call it
    from several threads, and a solve touches process-wide state: the
    kernels' launch counters, the global TF32 flags that the dense products
    save and restore, and the band kernel's cooperative grid, which takes
    every SM of the card.  Requests stay stateless; they queue.

    On a CUDA device the kernels are built here, before any server accepts
    a request.  With no CUDA device, ``device="cuda"`` raises: nothing falls
    back to the CPU or to a kernel's plain version.  Each call appends its
    host timings to ``optimize.timings``, a deque of dicts with
    ``to_device_ms``, ``layout_ms`` and ``solve_ms`` that keeps the last
    ``TIMINGS_KEPT`` requests (a server runs for long; the caller may clear
    it).
    """
    from toyslam_torch.optimizer import GaussNewton

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: no CUDA device")
        from toyslam_torch import kernels

        kernels.load_all()
    gn = GaussNewton(cfg or OptimizerConfig(solver="schur"))
    lock = threading.Lock()
    timings: collections.deque = collections.deque(maxlen=TIMINGS_KEPT)

    def optimize(graph: FactorGraph2D) -> FactorGraph2D:
        with lock:
            t0 = time.perf_counter()
            with tracing.span("toyslam.io.server.to_device"):
                on_device = graph.to(device)
            t1 = time.perf_counter()
            with tracing.span("toyslam.io.server.layout"):
                prepared = gn._prepare(on_device)
            t2 = time.perf_counter()
            result = gn.optimize(prepared)
            poses = result.graph.poses.cpu()       # waits for the device
            landmarks = result.graph.landmarks.cpu()
            t3 = time.perf_counter()
            timings.append({
                "to_device_ms": (t1 - t0) * 1e3,
                "layout_ms": (t2 - t1) * 1e3,
                "solve_ms": (t3 - t2) * 1e3,
            })
        return dataclasses.replace(graph, poses=poses, landmarks=landmarks)

    optimize.timings = timings
    return optimize


def native_server(
    backend: str = "torch",
    host: str = "127.0.0.1",
    port: int = 0,
    cfg: Optional[OptimizerConfig] = None,
    num_threads: int = 4,
    device="cuda",
):
    """Create (unstarted) a native TCP server for the given backend."""
    from toyslam_torch.io.native import NativeServer

    if backend not in ("torch", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    fn = None if backend == "native" else torch_optimize_fn(cfg, device)
    return NativeServer(fn, host=host, port=port, num_threads=num_threads)


class PyGraphServer:
    """Pure-Python asyncio server (protocol reference / fallback)."""

    def __init__(
        self,
        optimize_fn: OptimizeFn,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.optimize_fn = optimize_fn
        self.host = host
        self.port = port
        self.error: Optional[BaseException] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._started = threading.Event()

    async def _handle(self, reader, writer):
        try:
            while True:
                head = await reader.readexactly(4)
                (size,) = struct.unpack("<I", head)
                body = await reader.readexactly(size)
                graph = codec.bytes_to_graph(head + body)
                try:
                    result = await asyncio.get_event_loop().run_in_executor(
                        None, self.optimize_fn, graph
                    )
                except Exception as exc:  # kept for the owner; no answer
                    self.error = exc
                    break
                writer.write(codec.graph_to_bytes(result))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            writer.close()

    async def _serve(self):
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        async with self._server:
            await self._server.serve_forever()

    def start(self) -> "PyGraphServer":
        """Run the server on a background thread with its own loop."""

        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self._serve())
            except asyncio.CancelledError:
                pass
            finally:
                self._loop.close()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("server failed to start")
        return self

    def stop(self) -> None:
        if self._loop is not None and self._server is not None:
            def _shutdown():
                self._server.close()
                for task in asyncio.all_tasks(self._loop):
                    task.cancel()

            self._loop.call_soon_threadsafe(_shutdown)
        if self._thread is not None:
            self._thread.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
