"""The upstream robot: the scripted ToySlam run in its 422-point
environment, scanned by a 2D LiDAR (``generators.robot``)."""

from slambench.generators import robot as generate  # noqa: F401
