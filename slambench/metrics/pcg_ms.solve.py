"""Host milliseconds of the PCG per solve: the self time of the program's
``toyslam.ops.pcg`` spans (the operator's build and the chunk loop, the
waits at its once-a-chunk flag reads included) per ``toyslam.gn.optimize``
span."""

from slambench.spans import per_optimize_ms


def read(readings):
    return per_optimize_ms(readings.trace, "toyslam.ops.pcg")
