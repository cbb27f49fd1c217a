"""Matplotlib visualization (optional: imported only where a view is asked
for).  Everything also renders headless under the Agg backend."""

from toyslam_torch.view.view2d import (
    View,
    RobotStateView,
    FootprintView2d,
    GraphView2d,
    render_result,
)

__all__ = [
    "View",
    "RobotStateView",
    "FootprintView2d",
    "GraphView2d",
    "render_result",
]
