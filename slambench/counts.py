"""Operations and bytes of one launch of the port's PCG kernels, and the
card's peaks: the yardstick of the ``*_roofline`` metrics.

The rule (NVIDIA H100 roofline, each input byte read once and each output
byte written once per launch, whatever the kernel reads again): the least
time of a launch is the larger of its bytes at the HBM rate and its f32
operations at the f32 rate outside the tensor cores.  The operations are
those of the plain version's arithmetic for the iterations this launch
ran (``active``: the PCG iterations the launch advanced, read from its
state), not those of the most it could run:

* a matvec ``S p = T p - V (V^T p)``: 4 operations per element of V (two
  passes of a multiply-add), 6 dp^2 per pose for the block-tridiagonal T;
* a preconditioner apply: the PCR levels' two block products and the
  reduced diagonal, ``(4 L + 2) dp^2`` per pose, and with a coarse level
  ``R Sc^-1 R^T``: the dense ``2 (dp nc)^2`` plus the restriction and
  prolongation (B1 multiplies by ``rmat``, ``4 dp n nc``; B2 takes the
  groups as consecutive runs, ``2 dp n``);
* the vector updates and dot products, ``10 dp`` per pose an iteration;
* ``active + 1`` matvecs (the last the true residual), ``active`` applies
  plus one where the launch restarts the direction.

Bytes: every tensor the launch takes (operator, preconditioner, the right
side and the four state vectors in and out).  B2 reads no ``rmat`` (it
checks the restriction once per tensor on the host).  B2's tile stack
counts once per launch, not once per matvec trip as ``chip_smoke.py``'s
``chunk_bound`` counts it for stacks larger than the L2; so a share of
100 % is the card's floor for the work, whatever kernel does it.

Copied from ``chip_smoke.py::chunk_bound`` and restated to that rule.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, at its 700 W limit): HBM3 bytes/s and f32
# FLOP/s outside the tensor cores
PEAK_HBM_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def launch_bound(kernel: str, shapes: dict, active: int,
                 restart: bool) -> dict:
    """The least time of one launch.  ``kernel``: "b1" or "b2";
    ``shapes``: the launch's tensors by name, each ``(shape, element
    bytes)`` (None where absent), among them ``rhs [dp, Np]``, ``alphas
    [L, dp, dp, Np]``, ``u`` (V; B2: the wide columns), ``tiles`` (B2) and
    ``cinv [dp, dp, nc, nc]``; ``active``: PCG iterations the launch
    advanced; ``restart``: whether it restarted the direction."""
    dp, n = shapes["rhs"][0]
    band = kernel == "b2"
    skip = {"rmat"} if band else set()
    vec = _numel(shapes["rhs"][0]) * shapes["rhs"][1]
    nbytes = sum(_numel(s) * b for name, v in shapes.items()
                 if v is not None and name not in skip
                 for s, b in (v,)) + 8 * vec + 32
    u = shapes.get("u")
    mv = 4 * _numel(u[0]) if u is not None else 0
    if band:
        mv += 4 * _numel(shapes["tiles"][0])
    mv += 6 * dp * dp * n
    levels = shapes["alphas"][0][0]
    pc = (4 * levels + 2) * dp * dp * n
    cinv = shapes.get("cinv")
    if cinv is not None:
        nc = cinv[0][-1]
        pc += (2 * dp * n if band else 4 * dp * n * nc) + 2 * (dp * nc) ** 2
    flops = (active + 1) * (mv + 10 * dp * n) + (active + int(restart)) * pc
    t_bytes = nbytes / PEAK_HBM_BYTES_S
    t_ops = flops / PEAK_F32_FLOPS
    return {"seconds": max(t_bytes, t_ops), "bytes": nbytes, "flops": flops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def roofline_pct(readings, kernel: str, match) -> float | None:
    """A kernel's share of its roofline over the traced window, in %: the
    sum of its launches' least times over the sum of their device times,
    taken from the profiler's kernel events launched inside the window
    (``trace.Trace.launched``) that ``match`` picks by name.  None where
    the kernel did not run; raises where the profiler's count of its
    events differs from the launches recorded, since the shares would then
    not be of the same work."""
    recs = [r for r in readings.launches if r["kernel"] == kernel]
    if not recs:
        return None
    least = sum(launch_bound(kernel, r["shapes"], r["active"],
                             r["restart"])["seconds"] for r in recs)
    device = [d for n, _, d in readings.trace.launched if match(n)]
    if len(device) != len(recs):
        raise ValueError(f"{kernel}: the profiler shows {len(device)} kernel "
                         f"events launched in the window, {len(recs)} "
                         "launches were recorded")
    return 100.0 * least / sum(device)
