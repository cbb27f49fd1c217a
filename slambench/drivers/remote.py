"""The ``remote`` driver: ``GraphClient.optimize`` over TCP against the
port's ``PyGraphServer(torch_optimize_fn(cfg, device))`` in a process of
its own (``slambench/server.py``), one client, closed loop.  The client
is in this process; the server is started here and stopped by
:meth:`Driver.close`.  ``fault`` is passed to the server (the tests'
broken answers).  A traced run has the server profile a few requests
after the window (the mix's ``traced_requests``).
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

from slambench import generators, stats


class Driver:
    def __init__(self, cell, seed: int, device: torch.device,
                 fault: str = "none"):
        from toyslam_torch.io.client import GraphClient
        from toyslam_torch.models.graph import graph_from_numpy

        self.cell = cell
        t0 = time.perf_counter()
        self.problems = generators.pool(cell.graph, seed, cell.root)
        self.graphs = [graph_from_numpy(**p["graph"]) for p in self.problems]
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
        self.n_window = len(self.answers) - self.n_warm
        self.proc.send_signal(signal.SIGUSR1)
        time.sleep(0.5)
        for _ in range(self.cell.traffic["traced_requests"]):
            self.call()
        return out

    def end_to_end(self, times: list, window_s: float) -> dict:
        return stats.closed_loop("request", times, window_s)

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
