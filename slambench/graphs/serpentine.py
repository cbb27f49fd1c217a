"""The city-scale sweep: a serpentine over a jittered landmark grid, each
pose observing its nearest landmarks (``generators.serpentine``)."""

from slambench.generators import serpentine as generate  # noqa: F401
