"""PCG iterations per Gauss-Newton iteration, over the window's solves
(the program's ``OptimizeResult.pcg_iters`` and ``iterations_run``)."""


def read(readings):
    runs = [(sum(pcg[:its]), its) for pcg, its in readings.counters if its]
    if not runs:
        return None
    return sum(p for p, _ in runs) / sum(i for _, i in runs)
