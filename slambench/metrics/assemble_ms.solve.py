"""Host milliseconds of assembly per solve: the self time of the
program's ``toyslam.ops.assemble`` spans (residuals, Jacobians, the block
system; the refresh's assembly too) per ``toyslam.gn.optimize`` span."""

from slambench.spans import per_optimize_ms


def read(readings):
    return per_optimize_ms(readings.trace, "toyslam.ops.assemble")
