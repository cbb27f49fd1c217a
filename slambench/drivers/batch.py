"""The ``batch`` driver: ``GaussNewton.optimize`` in process, one caller
back to back (closed loop), each call ending with the optimized poses and
landmarks on the host.  The program's graph of each generated one is the
configuration's family's (``families/<name>.py``), so that a family added
as a file runs through this driver as it is.

The graphs are laid out (host tables, band plan) once in set-up, as a
caller who solves one map again and again would; each call solves the
pool's next graph from its initial state.  The layout of a new map is
outside the window.

What ``run.py`` asks of a driver (``drivers/<name>.py``, class
``Driver``):

* ``Driver(cell, seed, device, fault)``, with ``problems`` (the generated
  graphs), ``graphs`` (what a call takes), ``answers`` (per call: graph
  index, poses, landmarks, and the chi^2 per GN iteration or None) and
  ``setup_split`` (where set-up went, in seconds);
* ``call()``: one call; its host seconds;
* ``mark()``: the warm-up is over, the window starts;
* ``traced(window, seconds, readings)``: ``window(seconds)`` run under what
  the driver traces, filling ``readings``;
* ``after_window(traced)``: what the driver does once the window has
  closed and the host's speed has been read, before ``close``;
* ``end_to_end(times, window_s)``: the end-to-end metrics but ``setup_s``;
* ``close(readings)``: frees the program's state and returns the device's
  record (``kind``, ``memory_peak_bytes``, ``launches_per_call``; after a
  traced window ``busy_s``, ``window_s``, ``breakdown``).
"""

from __future__ import annotations

import time

import torch

from slambench import cells, generators, stats, trace

# the kernels, by the name of the program's launch counter
COUNTERS = {"b1": "fused_pcg_chunk", "b2": "band_fused_pcg_chunk"}


class Driver:
    def __init__(self, cell, seed: int, device: torch.device,
                 fault: str = "none"):
        from toyslam_torch.config import OptimizerConfig
        from toyslam_torch.optimizer import GaussNewton

        self.device = device
        t = [time.perf_counter()]
        self.problems = generators.pool(cell.graph, seed, cell.root)
        t.append(time.perf_counter())
        self.gn = GaussNewton(OptimizerConfig(**cell.config["optimizer"]))
        program_graph = cells.family(cell).program_graph
        graphs = [self.gn._prepare(program_graph(p["graph"]))
                  for p in self.problems]
        t.append(time.perf_counter())
        self.graphs = [g.to(device) for g in graphs]
        t.append(time.perf_counter())
        self.setup_split = dict(zip(("generate_s", "layout_s", "to_device_s"),
                                    (b - a for a, b in zip(t, t[1:]))))
        self.answers, self.counters = [], []
        self.n_warm, self.launches0 = 0, None

    def call(self) -> float:
        """Solve the pool's next graph; its host seconds."""
        i = len(self.answers) % len(self.graphs)
        t0 = time.perf_counter()
        res = self.gn.optimize(self.graphs[i])
        poses = res.graph.poses.cpu()        # waits for the device
        landmarks = res.graph.landmarks.cpu()
        seconds = time.perf_counter() - t0
        self.answers.append((i, poses, landmarks, res.errors))
        self.counters.append((res.pcg_iters, res.iterations_run))
        return seconds

    def launches(self) -> dict:
        from toyslam_torch.ops import fused_pcg as fp

        return {c: getattr(fp, c).launches for c in COUNTERS.values()}

    def mark(self):
        self.n_warm = len(self.answers)
        self.launches0 = self.launches()

    def traced(self, window, seconds: float, readings):
        """The window under ``torch.profiler``, with each kernel launch's
        operand shapes and iterations recorded: the PCG chunk loop is
        wrapped, not the kernels' wrappers, whose launch counters stay the
        program's.  Raises where the launches recorded differ from those
        the program counted."""
        from toyslam_torch.ops import fused_pcg as fp

        records = []
        saved = fp._chunked_pcg

        def chunked_pcg(chunk, *args, **kw):
            kernel = "b2" if chunk is fp.band_fused_pcg_chunk else "b1"
            return saved(_recorder(chunk, kernel, records), *args, **kw)

        before = self.launches()
        fp._chunked_pcg = chunked_pcg
        try:
            with trace.profiled(self.device) as held:
                out = window(seconds)
        finally:
            fp._chunked_pcg = saved
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        after = self.launches()
        for kernel, counter in COUNTERS.items():
            counted = after[counter] - before[counter]
            recorded = sum(r["kernel"] == kernel for r in records)
            if counted != recorded:
                raise RuntimeError(
                    f"{counter}: {counted} launches counted in the traced "
                    f"window, {recorded} recorded through "
                    "fused_pcg._chunked_pcg")
        readings.trace = held.trace
        readings.launches = finish_records(records)
        return out

    def after_window(self, traced: bool):
        pass

    def end_to_end(self, times: list, window_s: float) -> dict:
        return stats.closed_loop("solve", times, window_s)

    def close(self, readings) -> dict:
        """Free the program's state; the answers' chi^2 come to the host."""
        cuda = self.device.type == "cuda"
        n = max(len(self.answers) - self.n_warm, 1)
        now = self.launches()
        start = self.launches0 or now
        record = {
            "kind": torch.cuda.get_device_name(self.device) if cuda else "cpu",
            "memory_peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                                  if cuda else 0),
            "launches_per_call": {k: (now[k] - start[k]) / n for k in now}}
        if readings.trace is not None:
            record.update(busy_s=readings.trace.busy_s,
                          window_s=readings.trace.window_s,
                          breakdown=trace.breakdown([readings.trace]))
        readings.counters = [(pcg.cpu().tolist(), its)
                             for pcg, its in self.counters]
        self.answers = [(i, p, l_, e.cpu()) for i, p, l_, e in self.answers]
        self.gn = self.graphs = self.counters = None
        return record


def _recorder(orig, kernel: str, records: list):
    """``orig`` (a kernel's wrapper) recording each launch on the card:
    its operands' shapes, whether it restarts the direction, and its
    state's iteration counts in and out."""
    def launch(op, pre, rhs, st, atol2, maxit, restart, chunk_iters):
        out = orig(op, pre, rhs, st, atol2, maxit, restart, chunk_iters)
        if rhs.device.type == "cuda":
            shapes = {"rhs": (tuple(rhs.shape), rhs.element_size())}
            for part in (op, pre):
                for name, t in zip(part._fields, part):
                    shapes[name] = ((tuple(t.shape), t.element_size())
                                    if torch.is_tensor(t) else None)
            records.append({"kernel": kernel, "shapes": shapes,
                            "restart": bool(restart), "it_in": st.it,
                            "it_out": out.it})
        return out

    return launch


def finish_records(records: list) -> list:
    """The recorded launches with the iterations each advanced read."""
    return [{"kernel": r["kernel"], "shapes": r["shapes"],
             "restart": r["restart"],
             "active": int(r["it_out"].reshape(-1)[0])
             - int(r["it_in"].reshape(-1)[0])} for r in records]
