"""B1's share of its roofline over the traced window (kernel B1,
``csrc/fused_pcg_chunk.cu``; both of its schedules' kernels)."""

from slambench.counts import roofline_pct


def _b1(name: str) -> bool:
    return "band_" not in name and ("fused_pcg_chunk_kernel" in name
                                    or "fused_pcg_split_kernel" in name)


def read(readings):
    return roofline_pct(readings, "b1", _b1)
