"""Host milliseconds of the SE(3) edges per solve: the self time of the
program's ``toyslam.ops.edges3d`` spans (the relative-pose residuals with
their ``jacfwd`` Jacobians and the reprojection blocks inside the
assembly, and the residuals of the step rejection's chi^2) per
``toyslam.gn.optimize`` span; None where the trace holds none of them (a
program without the span)."""

from slambench import spans


def read(readings):
    tr = readings.trace
    if tr is None or not spans.count(tr, "toyslam.ops.edges3d"):
        return None
    return spans.per_optimize_ms(tr, "toyslam.ops.edges3d")
