"""The roofline counts: every input byte once per launch, at the main
path's B1 launch and at the 10k configuration's B2 stack."""

import pytest

from slambench import cells, counts, generators

F32 = 4


def _b1_main_path(cinv=None):
    """B1's operands on the main path: Np=192 poses of dp=3, Mw=768 V
    columns (2 x 384 padded landmarks), L=8 PCR levels."""
    dp, n, mw, levels = 3, 192, 768, 8
    plane = ((dp, dp, n), F32)
    return {"rhs": ((dp, n), F32), "u": ((dp, n, mw), F32),
            "tdiag": plane, "tupper": plane, "tlower": plane,
            "alphas": ((levels, dp, dp, n), F32),
            "gammas": ((levels, dp, dp, n), F32), "binv": plane,
            "cinv": cinv, "rmat": None}


def test_b1_main_path_launch_is_bound_by_its_bytes():
    b = counts.launch_bound("b1", _b1_main_path(), active=16, restart=True)
    # V once (1,769,472 B), three T planes (20,736), the PCR factors
    # (110,592), the reduced diagonal (6,912), the right side (2,304), four
    # state vectors in and out (18,432) and the scalars (32): 1.93 MB
    assert b["bytes"] == 1_928_480
    # 17 matvecs (16 iterations and the true residual): 4 a V element, 6
    # dp^2 a pose for T, 10 dp a pose of vector work; 17 applies (16 and
    # the restart's) of 8 PCR levels: (4 L + 2) dp^2 a pose
    assert b["flops"] == 17 * (4 * 3 * 192 * 768 + 6 * 9 * 192
                               + 10 * 3 * 192) + 17 * (34 * 9 * 192)
    assert b["bound_by"] == "bytes"
    assert b["seconds"] == pytest.approx(1_928_480 / 3.35e12)


def test_b1_counts_only_the_iterations_a_launch_ran():
    full = counts.launch_bound("b1", _b1_main_path(), 16, False)
    tail = counts.launch_bound("b1", _b1_main_path(), 3, False)
    assert tail["bytes"] == full["bytes"]
    assert tail["flops"] < full["flops"] / 4


def test_b2_counts_the_10k_stack_once_a_launch():
    """The 10k configuration's layout from the port's own plan: the tile
    stack (larger than the 50 MB L2) counts once, not once per matvec trip
    as ``chip_smoke.py::chunk_bound`` counts it."""
    from toyslam_torch.config import OptimizerConfig
    from toyslam_torch.models.graph import graph_from_numpy
    from toyslam_torch.ops.grid_schur import build_grid_plan

    c = cells.cell("sparse-10k.batch")
    p = generators.generate(c.graph, 0)
    band = build_grid_plan(graph_from_numpy(**p["graph"])).band
    opt = OptimizerConfig(**c.config["optimizer"])
    n, dp, nc = 10_240, 3, 10_240 // opt.pcg_coarse_group
    levels = (n - 1).bit_length()
    plane = ((dp, dp, n), F32)
    shapes = {
        "rhs": ((dp, n), F32),
        "tiles": ((band.n_chunks, band.k_windows, dp, band.w_row,
                   band.chunk_b * 2), F32),
        "win_off": (tuple(band.win_off.shape), 4),
        "cover": (tuple(band.cover.shape), 4),
        "u": ((dp, 2 * band.n_wide, n), F32) if band.n_wide else None,
        "tdiag": plane, "tupper": plane, "tlower": plane,
        "alphas": ((levels, dp, dp, n), F32),
        "gammas": ((levels, dp, dp, n), F32), "binv": plane,
        "cinv": ((dp, dp, nc, nc), F32), "rmat": ((n, nc), F32),
    }
    b = counts.launch_bound("b2", shapes, active=15, restart=True)
    stack = band.tile_bytes
    assert stack > 50 * 2**20
    rest = b["bytes"] - stack
    # everything but the stack: the 14 PCR levels' factors (10.3 MB), the
    # coarse inverse (3.7 MB), the cover table, planes and vectors; B2
    # reads no restriction matrix
    factors = 2 * levels * dp * dp * n * F32
    assert factors + dp * dp * nc * nc * F32 < rest < 0.1 * stack
    no_rmat = dict(shapes, rmat=None)
    assert counts.launch_bound("b2", no_rmat, 15, True)["bytes"] == b["bytes"]
    assert b["bound_by"] == "bytes"
    per_trip = b["bytes"] + 15 * stack          # chunk + 1 trips
    assert per_trip / b["bytes"] > 14


def _readings(n_events, n_launches):
    from slambench import run, trace

    r = run.Readings()
    launched = [("fused_pcg_chunk_kernel<3>", 0.1 * i, 2e-4)
                for i in range(n_events)] + [("elementwise", 0.9, 1e-3)]
    # one more B1 event inside the window, launched before it: not counted
    r.trace = trace.Trace(
        window_s=1.0, busy_s=0.5,
        device=[("fused_pcg_chunk_kernel<3>", 0.0, 2e-4)] + launched,
        host=[], gaps=[], launched=tuple(launched))
    r.launches = [{"kernel": "b1", "shapes": _b1_main_path(), "active": 16,
                   "restart": False}] * n_launches
    return r


def test_a_roofline_share_reads_the_profilers_kernel_events_alone():
    b1 = cells.reader("b1_roofline")
    least = counts.launch_bound("b1", _b1_main_path(), 16, False)["seconds"]
    assert b1(_readings(3, 3)) == pytest.approx(100 * least / 2e-4)
    assert b1(_readings(0, 0)) is None          # the kernel did not run
    with pytest.raises(ValueError, match="2 kernel events"):
        b1(_readings(2, 3))                     # not the same work
