"""B2's share of its roofline over the traced window (kernel B2,
``csrc/band_fused_pcg_chunk.cu``)."""

from slambench.counts import roofline_pct


def read(readings):
    return roofline_pct(readings, "b2",
                        lambda name: "band_fused_pcg_chunk_kernel" in name)
