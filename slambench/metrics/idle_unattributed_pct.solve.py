"""The share of the traced window's device-idle time that no phase span
explains: the idle gaps whose middle lies in no ``toyslam.ops.*`` and no
``toyslam.gn.update`` span (the caller's copies to the host between
solves, the GN loop's set-up, the glue of an iteration), in % of all idle
time.  None where the trace holds no ``toyslam.gn.optimize`` span, no
device activity or no idle time."""

from slambench import spans


def read(readings):
    tr = readings.trace
    if tr is None or not tr.device or not spans.count(tr, spans.OPTIMIZE):
        return None
    idle = sum(d for _, d in tr.gaps)
    if idle <= 0:
        return None
    phases = [x for x in spans.program_spans(tr)
              if x[0].startswith("toyslam.ops.")
              or x[0] == "toyslam.gn.update"]
    mids = [s + 0.5 * d for s, d in tr.gaps]
    attributed = spans.inside(mids, phases)
    unattributed = sum(d for (_, d), a in zip(tr.gaps, attributed) if not a)
    return 100.0 * unattributed / idle
