"""Host waits on the device per Gauss-Newton iteration: the CUDA runtime's
synchronisations (``spans.SYNCS``) that start inside the program's
``toyslam.gn.optimize`` spans, per ``toyslam.gn.iteration`` span.  Read
from the runtime's own events, so a wait hidden in a torch op whose output
shape depends on the data counts too.  None without device activity,
where nothing waits for a device."""

from slambench import spans


def read(readings):
    tr = readings.trace
    if tr is None or not tr.device:
        return None
    iterations = spans.count(tr, spans.ITERATION)
    if not iterations:
        return None
    solves = [x for x in spans.program_spans(tr) if x[0] == spans.OPTIMIZE]
    starts = [s for n, s, _ in tr.host if n in spans.SYNCS]
    return float(spans.inside(starts, solves).sum()) / iterations
