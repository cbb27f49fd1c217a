"""One run of one cell of the port's benchmark.

    python -m slambench.run --workload CELL --seed N --seconds S --trace 0|1

Set-up builds the cell's graphs from ``--seed`` (``graphs/<kind>.py``),
has the mix's driver (``drivers/<name>.py``) lay them out or start the
server, and warms every shape up; ``setup_s`` runs from the process's
start to the first timed call.  Then one caller calls the program back to
back for ``--seconds`` (``--trace 0``: the end-to-end metrics) or for the
mix's ``trace_seconds`` under the driver's tracing (``--trace 1``: the
per-layer metrics, with the device's busy time and a breakdown).  The
host's speed around the window is read (``host.py``), and the driver does
what it does once a window has closed (the remote driver: a profiled pass
over the pool).  Then the peak memory is read, the program's state freed,
and every answer the run produced is compared with the plain reference's,
by the configuration's family (``families/<name>.py``, ``check.py``).

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``host``, and last ``compared``, each compared number
with its limit (also the last lines of standard error).  Exits 2 without
the CUDA devices the cell asks for, 4 when a JAX module was loaded, and
with no result line in either case.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import traceback

_T0 = time.monotonic()


def _process_seconds() -> float:
    """Seconds since this process started (from /proc where it exists)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T0


def _window(driver, seconds: float):
    """Calls back to back until ``seconds`` have passed: the host seconds
    of each finished call, the failures, and the window's length."""
    times, failed = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        try:
            times.append(driver.call())
        except Exception:          # a failed call is counted, not fatal
            if not failed:
                traceback.print_exc()
            failed += 1
    return times, failed, time.perf_counter() - t0


class Readings:
    """What the per-layer readers read: the window's calls, the program's
    counters, the trace, the recorded launches and the server's record."""

    def __init__(self):
        self.times = []            # host seconds of each window call
        self.window_s = 0.0        # the window's host seconds
        self.counters = []         # (pcg_iters per GN iteration, iterations)
        self.trace = None          # trace.Trace of the traced window
        self.launches = []         # drivers/batch.py's launch records
        self.server_window = []    # the server's timings of the window


def run(cell, seed: int, seconds: float, traced: bool, device,
        fault: str = "none", out=None) -> int:
    """One run of ``cell`` on ``device``; prints the result line to
    ``out`` and returns the exit code.  The cell's driver
    (``drivers/<name>.py``) calls the program; ``fault`` goes to it."""
    import torch

    from slambench import cells, check, host

    out = out or sys.stdout
    driver = cells.driver(cell)(cell, seed, device, fault)
    cuda = device.type == "cuda"
    readings = Readings()
    try:
        split = driver.setup_split
        split["process_s"] = _process_seconds()
        for i in range(max(cell.traffic["warmup_calls"],
                           len(driver.graphs))):
            split[f"warmup{i}_s"] = driver.call()
        print(json.dumps({"setup_split": split}), file=sys.stderr)
        if cuda:
            torch.cuda.synchronize(device)
        driver.mark()
        setup_s = _process_seconds()
        start = host.before()
        if traced:
            times, failed, window_s = driver.traced(
                lambda s: _window(driver, s), cell.traffic["trace_seconds"],
                readings)
        else:
            times, failed, window_s = _window(driver, seconds)
        host_record = host.after(start)
        driver.after_window(traced)
    finally:
        record = driver.close(readings)
    answers, problems = driver.answers, driver.problems
    values = {**driver.end_to_end(times, window_s), "setup_s": setup_s}
    readings.times, readings.window_s = times, window_s
    print(json.dumps({"calls": len(times),
                      "launches_per_call": record["launches_per_call"]}),
          file=out, flush=True)

    # the program's state is freed; the reference runs alone
    del driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.worst_over_pool(cells.family(cell), problems,
                                    cell.config["optimizer"], answers, device)
    correct, compared = check.judge(numbers, cell.config["correct"])
    correct = correct and failed == 0 and len(times) > 0

    metrics = {}
    if not traced:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = cells.reader(m["name"], cell.root)(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": record["kind"],
           "count": cell.chips,
           "memory_peak_bytes": record["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": len(times) + failed,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = record.get("busy_s", 0.0)
        dev["window_s"] = record.get("window_s", 0.0)
        result["breakdown"] = record.get("breakdown")
    result["host"] = host_record
    result["compared"] = compared

    found = sorted(set(cells.forbidden_modules())
                   | set(record.get("forbidden_modules", [])))
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(result), file=out, flush=True)
    for k, c in compared.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from slambench import cells

    cell = cells.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return run(cell, args.seed, args.seconds, bool(args.trace),
               torch.device("cuda", 0))


if __name__ == "__main__":
    sys.exit(main())
