"""Host milliseconds of the preconditioner's builds per solve: the self
time of the program's ``toyslam.ops.precond`` spans (the diagonal blocks
of S, the PCR planes, the coarse level; not the refresh's assembly, which
is its own span) per ``toyslam.gn.optimize`` span."""

from slambench.spans import per_optimize_ms


def read(readings):
    return per_optimize_ms(readings.trace, "toyslam.ops.precond")
