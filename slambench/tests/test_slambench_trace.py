"""The traced window's readings from a hand-built list of profiler events:
the kernels of the window's work taken by the launch that issued them, the
busy time and the gaps by the events' own timestamps."""

import pytest

from slambench import trace

W = trace.WINDOW_SPAN


def _events():
    """``(name, start_ns, duration_ns, on_device, correlation_id)``: a
    window from 1,000 to 2,000 ns on the host's clock."""
    return [
        (W, 1000, 1000, False, 1),
        # launched before the window, running into it
        ("cudaLaunchKernel", 900, 20, False, 10),
        ("fused_pcg_chunk_kernel<3>", 950, 100, True, 10),
        # launched inside it: a cluster launch, a cooperative launch and a
        # driver-API launch, the last kernel stamped past the window's end
        ("cudaLaunchKernelExC", 1100, 20, False, 11),
        ("fused_pcg_chunk_kernel<3>", 1200, 100, True, 11),
        ("cudaLaunchCooperativeKernel", 1400, 20, False, 12),
        ("pcr_factor_kernel<3>", 1500, 100, True, 12),
        ("cuLaunchKernelEx", 1980, 10, False, 13),
        ("band_fused_pcg_chunk_kernel<3,0>", 2050, 100, True, 13),
        # a copy: no launch call, and a torch op sharing its id by chance
        ("cudaMemcpyAsync", 1700, 10, False, 14),
        ("Memcpy DtoH", 1720, 30, True, 14),
        ("aten::mul", 1600, 10, False, 14),
        # launched after the window
        ("cudaLaunchKernel", 2100, 10, False, 15),
        ("fused_pcg_chunk_kernel<3>", 2200, 100, True, 15),
    ]


def test_a_kernel_is_taken_by_the_launch_that_issued_it():
    tr = trace.read(_events())
    names = [(n, round(s * 1e9), round(d * 1e9)) for n, s, d in tr.launched]
    assert names == [("fused_pcg_chunk_kernel<3>", 200, 100),
                     ("pcr_factor_kernel<3>", 500, 100),
                     ("band_fused_pcg_chunk_kernel<3,0>", 1050, 100)]


def test_busy_time_and_gaps_read_the_timestamps_inside_the_window():
    tr = trace.read(_events())
    assert tr.window_s == pytest.approx(1e-6)
    # the device activities overlapping the window, as before: the kernel
    # launched before it counts, the one stamped past its end does not
    assert [n for n, _, _ in tr.device] == [
        "fused_pcg_chunk_kernel<3>", "fused_pcg_chunk_kernel<3>",
        "pcr_factor_kernel<3>", "Memcpy DtoH"]
    assert tr.busy_s == pytest.approx((50 + 100 + 100 + 30) * 1e-9)
    got = [(round(s * 1e9), round(d * 1e9)) for s, d in tr.gaps]
    assert got == [(50, 150), (300, 200), (600, 120), (750, 250)]
    assert [n for n, _, _ in tr.host] == [
        "cudaLaunchKernel", "cudaLaunchKernelExC",
        "cudaLaunchCooperativeKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
        "aten::mul", "cudaLaunchKernel"]


def test_the_works_device_time_is_every_activity_unclipped():
    """The union of every device activity's interval, inside the window
    or not: the one launched before it, the one stamped past its end and
    the one launched after it count whole."""
    assert trace.read(_events()).work_s == pytest.approx(
        (100 + 100 + 100 + 30 + 100 + 100) * 1e-9)
    overlapping = [(W, 0, 1000, False, 1), ("k", 100, 300, True, 2),
                   ("k", 200, 100, True, 3), ("k", 350, 100, True, 4),
                   ("k", 700, 10, True, 5)]
    assert trace.read(overlapping).work_s == pytest.approx(360e-9)


def test_a_trace_without_its_window_span_is_refused():
    with pytest.raises(RuntimeError, match="span is missing"):
        trace.read(_events()[1:])
