"""The ``remote`` driver: ``GraphClient.optimize`` over TCP against the
port's ``PyGraphServer(torch_optimize_fn(cfg, device))`` in a process of
its own (``slambench/server.py``), one client, closed loop.  The client
is in this process; the server is started here and stopped by
:meth:`Driver.close`.  ``fault`` is passed to the server (the tests'
broken answers).

After the window the server profiles requests, each alone: in a traced
run the mix's ``traced_requests`` of them (the busy share and the
breakdown), in an untraced one a request of each graph of the pool, whose
mean device time is the end-to-end ``device_ms.request``.  The client's
wall time per request follows the host's speed, which drifts by more than
a bound can hold; the traced run reports it per layer
(``metrics/request_ms.wall.py``).
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import torch

from slambench import cells, generators


class Driver:
    def __init__(self, cell, seed: int, device: torch.device,
                 fault: str = "none"):
        from toyslam_torch.io.client import GraphClient

        self.cell = cell
        t0 = time.perf_counter()
        self.problems = generators.pool(cell.graph, seed, cell.root)
        program_graph = cells.family(cell).program_graph
        self.graphs = [program_graph(p["graph"]) for p in self.problems]
        self.setup_split = {"generate_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        tmp = Path(os.environ.get("TMPDIR", "/tmp"))
        self.dump = tmp / f"slambench-server-{os.getpid()}.json"
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "slambench.server",
             "--config", str(cell.config_file), "--device", device.type,
             "--dump", str(self.dump), "--fault", fault],
            stdout=subprocess.PIPE, text=True, cwd=cell.root)
        try:
            line = self.proc.stdout.readline()
            if not line.startswith("port "):
                raise RuntimeError(f"the server did not start: {line!r}")
            self.loop = asyncio.new_event_loop()
            self.client = GraphClient("127.0.0.1", int(line.split()[1]))
            self.loop.run_until_complete(self.client.connect(timeout=60.0))
        except BaseException:
            self.proc.kill()
            self.proc.wait()
            raise
        self.setup_split["server_start_s"] = time.perf_counter() - t0
        self.answers = []
        self.n_warm, self.n_window = 0, None
        self.work_s = []

    def call(self) -> float:
        """Request the pool's next graph; the client's seconds."""
        i = len(self.answers) % len(self.graphs)
        t0 = time.perf_counter()
        out = self.loop.run_until_complete(
            self.client.optimize(self.graphs[i]))
        seconds = time.perf_counter() - t0
        self.answers.append((i, out.poses, out.landmarks, None))
        return seconds

    def mark(self):
        self.n_warm = len(self.answers)

    def traced(self, window, seconds: float, readings):
        """The window as it is, then the server profiles the next
        requests."""
        out = window(seconds)
        self._profile(self.cell.traffic["traced_requests"])
        return out

    def after_window(self, traced: bool):
        """An untraced window has closed: the server profiles one request
        of each graph of the pool."""
        if not traced:
            self._profile(len(self.graphs))

    def _profile(self, requests: int):
        self.n_window = len(self.answers) - self.n_warm
        self.proc.send_signal(signal.SIGUSR1)
        time.sleep(0.5)
        for _ in range(requests):
            self.call()

    def end_to_end(self, times: list, window_s: float) -> dict:
        """``device_ms.request``: the mean device time of the requests the
        server profiled."""
        if not self.work_s:
            raise RuntimeError("the server profiled no request")
        return {"device_ms.request": 1e3 * sum(self.work_s)
                / len(self.work_s)}

    def close(self, readings) -> dict:
        """Stop the client and the server; the server's record, with its
        timings of the window's requests in ``readings``."""
        try:
            self.loop.run_until_complete(self.client.close())
        finally:
            self.loop.close()
            if self.proc.poll() is None:
                self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self.proc.returncode != 0:
            raise RuntimeError(f"the server exited {self.proc.returncode}")
        server = json.loads(self.dump.read_text())
        self.dump.unlink()
        if server.get("error"):
            raise RuntimeError(f"the server failed: {server['error']}")
        self.work_s = server.get("work_s", [])
        timings = server["timings"]
        n = (len(self.answers) - self.n_warm if self.n_window is None
             else self.n_window)
        readings.server_window = timings[self.n_warm: self.n_warm + n]
        record = {
            "kind": server.get("kind", "cpu"),
            "memory_peak_bytes": server.get("memory_peak_bytes", 0),
            "launches_per_call": {k: v / max(len(timings), 1)
                                  for k, v in server["launches"].items()},
            "forbidden_modules": server.get("forbidden_modules", [])}
        for k in ("busy_s", "window_s", "breakdown"):
            if k in server:
                record[k] = server[k]
        return record
