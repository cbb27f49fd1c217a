"""Coarse-to-fine initialization: put huge graphs inside the GN basin.

At 100k poses and default odometry noise, dead reckoning accumulates O(pi)
rotation error over the arena: the Gauss-Newton basin does not contain the
initial guess, and no solver speed fixes a wrong basin.  Real systems
initialize incrementally.  This module is the batch equivalent, the
functions of ``toyslam_tpu.optimizer.coarse_init`` over this package's
graph and optimizer:

1. **Decimate** the trajectory by ``factor``: keep every factor-th pose
   as an anchor; compose the odometry measurements inside each segment
   into one coarse odometry edge (information scaled 1/factor: the
   random-walk covariance grows about linearly); re-target every landmark
   observation to its segment anchor by pushing the measured body-frame
   point through the dead-reckoned relative pose (exactly the accumulated
   odometry, so the coarse problem's error model matches the fine one's at
   the dead-reckoned state).  Landmarks keep their identity, so loop
   closures (re-observed landmarks) survive decimation, which is what makes
   the coarse solve observable.
2. **Solve** the coarse problem (factor x fewer poses).
3. **Prolong**: anchor poses move to their optimized values; in-segment
   poses re-integrate the original odometry from their segment anchor
   (the correction is rigid per segment, smooth across segments because
   consecutive anchors were co-optimized); landmarks take their coarse
   estimates directly.

The result is a state for the full problem inside the basin; the normal
solver runs from there.  The arithmetic is host-side float64 numpy over
arrays read back from the graph (one-time, not the hot path); the solves
are ``GaussNewton.optimize`` on the graph's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from toyslam_torch.config import OptimizerConfig
from toyslam_torch.models.graph import (
    FactorGraph2D,
    graph_from_numpy,
    to_numpy as _np,
)


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Batched SE(2) compose on (x, y, theta) rows."""
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack([
        a[..., 0] + c * b[..., 0] - s * b[..., 1],
        a[..., 1] + s * b[..., 0] + c * b[..., 1],
        a[..., 2] + b[..., 2],
    ], axis=-1)


def _transform_point(pose: np.ndarray, pt: np.ndarray) -> np.ndarray:
    c, s = np.cos(pose[..., 2]), np.sin(pose[..., 2])
    return np.stack([
        pose[..., 0] + c * pt[..., 0] - s * pt[..., 1],
        pose[..., 1] + s * pt[..., 0] + c * pt[..., 1],
    ], axis=-1)


def _bucket(n: int, b: int) -> int:
    return max(b, -(-n // b) * b)


def decimate(
    graph: FactorGraph2D, factor: int,
    pose_bucket: int = 64, landmark_bucket: int = 64,
    edge_bucket: int = 256,
) -> tuple[FactorGraph2D, np.ndarray]:
    """Coarse graph + per-pose DR offset from its segment anchor.

    Requires chain odometry (j = i+1 for every real edge: every frontend
    trajectory and scale workload; raises otherwise).  Returns
    ``(coarse_graph, rel_dr)``: the coarse graph on ``graph``'s device, and
    ``rel_dr [n, 3]`` (float64 numpy), the composed odometry from pose
    ``factor*(p//factor)`` to pose ``p``.
    """
    n = int(_np(graph.pose_mask).sum())
    m = int(_np(graph.lm_mask).sum())
    oi = _np(graph.odom.i)
    oj = _np(graph.odom.j)
    om = _np(graph.odom.mask) > 0
    if not np.all(oj[om] == oi[om] + 1):
        raise ValueError("coarse_init requires chain-only odometry")
    # odometry measurement per chain row (row v = edge v -> v+1)
    meas_row = np.zeros((n, 3), np.float64)
    info_row = np.zeros((n, 3, 3), np.float64)
    meas_row[oi[om]] = _np(graph.odom.meas).astype(np.float64)[om]
    info_row[oi[om]] = _np(graph.odom.info).astype(np.float64)[om]

    nc = -(-n // factor)
    n_pad = nc * factor
    meas_pad = np.zeros((n_pad, 3))
    meas_pad[:n] = meas_row
    seg = meas_pad.reshape(nc, factor, 3)

    # cumulative in-segment DR: rel[:, 0] = identity, rel[:, k] =
    # rel[:, k-1] (+) meas[:, k-1]  — ``factor`` vectorized compose steps
    rel = np.zeros((nc, factor, 3))
    for k in range(1, factor):
        rel[:, k] = _compose(rel[:, k - 1], seg[:, k - 1])
    coarse_meas = _compose(rel[:, -1], seg[:, -1])     # anchor -> anchor
    rel_dr = rel.reshape(n_pad, 3)[:n]

    # coarse odometry info: segment-mean information scaled 1/factor
    # (random-walk covariance adds over the composed steps; exact
    # composition would rotate/adjoint each block: unnecessary for an
    # initializer)
    info_seg = np.zeros((n_pad, 3, 3))
    info_seg[:n] = info_row
    coarse_info = info_seg.reshape(nc, factor, 3, 3).mean(axis=1) / factor

    # landmark edges: re-target observation at pose p to anchor p//factor
    lp = _np(graph.lm_edges.pose)
    ll = _np(graph.lm_edges.lm)
    lmask = _np(graph.lm_edges.mask) > 0
    e = np.nonzero(lmask)[0]
    p = lp[e]
    meas = _np(graph.lm_edges.meas).astype(np.float64)[e]
    # body-frame point at p -> body frame of the segment anchor
    pt = np.stack([meas[:, 0] * np.cos(meas[:, 1]),
                   meas[:, 0] * np.sin(meas[:, 1])], axis=-1)
    pt_a = _transform_point(rel_dr[p], pt)
    meas_a = np.stack([
        np.hypot(pt_a[:, 0], pt_a[:, 1]),
        np.arctan2(pt_a[:, 1], pt_a[:, 0]),
    ], axis=-1)

    np_c = _bucket(nc, pose_bucket)
    mp_c = _bucket(m, landmark_bucket)
    ne_c = _bucket(len(e), edge_bucket)
    no_c = _bucket(nc - 1, edge_bucket)

    poses_c = np.zeros((np_c, 3), np.float32)
    poses_c[:nc] = _np(graph.poses)[np.arange(nc) * factor]
    landmarks_c = np.zeros((mp_c, 2), np.float32)
    landmarks_c[:m] = _np(graph.landmarks)[:m]
    pose_mask = np.zeros(np_c, np.float32)
    pose_mask[:nc] = 1.0
    lm_mask = np.zeros(mp_c, np.float32)
    lm_mask[:m] = 1.0
    pose_fixed = np.zeros(np_c, np.float32)
    pose_fixed[0] = float(_np(graph.pose_fixed)[0])
    lm_fixed = np.zeros(mp_c, np.float32)
    lm_fixed[:m] = _np(graph.lm_fixed)[:m]

    o_i = np.zeros(no_c, np.int32)
    o_j = np.zeros(no_c, np.int32)
    o_meas = np.zeros((no_c, 3), np.float32)
    o_info = np.zeros((no_c, 3, 3), np.float32)
    o_mask = np.zeros(no_c, np.float32)
    o_i[: nc - 1] = np.arange(nc - 1)
    o_j[: nc - 1] = np.arange(1, nc)
    o_meas[: nc - 1] = coarse_meas[: nc - 1]
    o_info[: nc - 1] = coarse_info[: nc - 1]
    o_mask[: nc - 1] = 1.0

    l_pose = np.zeros(ne_c, np.int32)
    l_lm = np.zeros(ne_c, np.int32)
    l_meas = np.zeros((ne_c, 2), np.float32)
    l_info = np.zeros((ne_c, 2, 2), np.float32)
    l_mask = np.zeros(ne_c, np.float32)
    l_pose[: len(e)] = (p // factor).astype(np.int32)
    l_lm[: len(e)] = ll[e]
    l_meas[: len(e)] = meas_a
    l_info[: len(e)] = _np(graph.lm_edges.info)[e]
    l_mask[: len(e)] = 1.0

    coarse = graph_from_numpy(
        poses_c, landmarks_c, pose_mask, lm_mask, pose_fixed, lm_fixed,
        (o_i, o_j, o_meas, o_info, o_mask),
        (l_pose, l_lm, l_meas, l_info, l_mask),
        device=graph.device,
    )
    return coarse, rel_dr


def prolong(
    graph: FactorGraph2D, coarse_opt: FactorGraph2D, rel_dr: np.ndarray,
    factor: int,
) -> FactorGraph2D:
    """Fine state from the optimized coarse state: each pose re-integrates
    its original in-segment odometry from the optimized segment anchor;
    landmarks take the coarse estimates."""
    n = rel_dr.shape[0]
    m = int(_np(graph.lm_mask).sum())
    anchors = _np(coarse_opt.poses).astype(np.float64)
    p = np.arange(n)
    poses_new = _np(graph.poses).copy()
    poses_new[:n] = _compose(anchors[p // factor], rel_dr).astype(
        poses_new.dtype
    )
    landmarks_new = _np(graph.landmarks).copy()
    landmarks_new[:m] = _np(coarse_opt.landmarks)[:m]
    dev = graph.device
    return graph.with_state(torch.from_numpy(poses_new).to(dev),
                            torch.from_numpy(landmarks_new).to(dev))


def incremental_init(
    graph: FactorGraph2D,
    window: int = 1024,
    iters_per_prefix: int = 5,
    solver_cfg: OptimizerConfig | None = None,
) -> FactorGraph2D:
    """Sequential prefix-window initialization (the real-systems order).

    Optimize poses ``[0, W)``, then ``[0, 2W)`` warm-started from the
    previous prefix with the new window dead-reckoned from the optimized
    prefix end, and so on.  Each solve only ever faces ONE window of
    fresh drift (sqrt(W) compounding instead of sqrt(N)), so every prefix
    stays inside the GN basin by induction — the property batch DR
    initialization loses at scale.

    Prefixes are expressed through the VALIDITY MASKS on the full-size
    graph (masks are data, not structure), so every prefix solve reuses
    ONE structure plan (gather tables, band layout), built once; the graph
    and its plan stay on the graph's device, and only the state and the
    four masks move there per window.  The inter-prefix state splice is
    host-side numpy.  Cost ~ (N/W) * iters_per_prefix full-shape GN
    iterations.

    In the final partial window, ``[hi - window, hi)`` overlaps the window
    before it, so landmarks first seen in the overlap are re-initialized
    and the overlap's poses re-aligned although they were already
    optimized: this is the JAX package's behaviour, reproduced as it is.

    Re-entry alignment (the relocalization step real systems do): when
    a new window re-observes landmarks mapped in an EARLIER part of the
    trajectory (another lap), the dead-reckoned window and the map
    disagree by the full inter-visit drift — outside the window solve's
    basin at scale (measured: the raw sweep recovers a 4k workload but
    not 100k).  Before each prefix solve, the new window is rigidly
    aligned to the existing map by closed-form weighted SE(2) Procrustes
    over its known-ID landmark correspondences; GN then refines from an
    in-basin start.
    """
    if solver_cfg is None:
        solver_cfg = OptimizerConfig(
            iterations=iters_per_prefix, lr=1.0, solver="schur",
            exact_odom_jacobians=True, pcg_tol=1e-2, pcg_max_iters=30,
            pcg_restart_every=30, pcg_precond="tridiag+coarse",
            pcg_coarse_group=32, pcg_precond_refresh=0,
            convergence_eps=0.0,
        )
    else:
        solver_cfg = dataclasses.replace(
            solver_cfg, iterations=iters_per_prefix, convergence_eps=0.0,
        )
    n = int(_np(graph.pose_mask).sum())
    oi = _np(graph.odom.i)
    oj = _np(graph.odom.j)
    om = _np(graph.odom.mask) > 0
    if not np.all(oj[om] == oi[om] + 1):
        raise ValueError("incremental_init requires chain-only odometry")
    meas_row = np.zeros((n, 3), np.float64)
    meas_row[oi[om]] = _np(graph.odom.meas).astype(np.float64)[om]

    lp = _np(graph.lm_edges.pose)
    ll = _np(graph.lm_edges.lm)
    lmask = _np(graph.lm_edges.mask) > 0
    m_total = graph.num_landmarks
    # landmark first observed at pose (for prefix lm masks)
    first_pose = np.full(m_total, n, np.int64)
    np.minimum.at(first_pose, ll[lmask], lp[lmask])

    lmeas = _np(graph.lm_edges.meas).astype(np.float64)

    # first observation EDGE per landmark (for fresh-landmark re-init):
    # graph.landmarks was initialized by the frontend pushing the first
    # observation through the DEAD-RECKONED pose — but this loop re-bases
    # every window onto the optimized-prefix frame, which diverges from
    # the raw DR frame by the full accumulated drift (hundreds of units
    # at 100k/default noise).  A landmark first seen in the new window
    # must therefore be re-initialized from its first observation through
    # the CURRENT pose estimate, or the window solve starts with huge
    # landmark residuals outside its basin (the measured 100k failure).
    e_real = np.nonzero(lmask)[0]
    order_first = np.lexsort((lp[e_real], ll[e_real]))
    lm_sorted = ll[e_real][order_first]
    uniq_lm, uniq_at = np.unique(lm_sorted, return_index=True)
    first_edge = np.full(m_total, -1, np.int64)
    first_edge[uniq_lm] = e_real[order_first][uniq_at]

    def _align_window(poses, landmarks, lo, hi):
        """Rigid SE(2) fit of the window's predicted old-landmark points
        onto their map estimates (correspondences by landmark ID —
        association is given, so this is closed-form Procrustes)."""
        sel = (lmask & (lp >= lo) & (lp < hi)
               & (first_pose[ll] < lo))
        idx = np.nonzero(sel)[0]
        if idx.size < 8:
            return poses
        mm = lmeas[idx]
        pt_body = np.stack([mm[:, 0] * np.cos(mm[:, 1]),
                            mm[:, 0] * np.sin(mm[:, 1])], axis=-1)
        pred = _transform_point(poses[lp[idx]], pt_body)
        mapped = _np(landmarks).astype(np.float64)[ll[idx]]
        cp, cm = pred.mean(axis=0), mapped.mean(axis=0)
        a = pred - cp
        b = mapped - cm
        s00 = float(np.sum(a[:, 0] * b[:, 0]))
        s11 = float(np.sum(a[:, 1] * b[:, 1]))
        s01 = float(np.sum(a[:, 0] * b[:, 1]))
        s10 = float(np.sum(a[:, 1] * b[:, 0]))
        th = np.arctan2(s01 - s10, s00 + s11)
        c, s = np.cos(th), np.sin(th)
        r = np.array([[c, -s], [s, c]])
        t = cm - r @ cp
        w = poses[lo:hi].copy()
        w[:, :2] = w[:, :2] @ r.T + t
        w[:, 2] += th
        poses[lo:hi] = w
        return poses

    from toyslam_torch.optimizer.gauss_newton import GaussNewton

    gn = GaussNewton(solver_cfg)
    base = gn._prepare(graph)   # structure plan built ONCE
    dev = graph.device

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    poses = _np(graph.poses).astype(np.float64).copy()
    landmarks = _np(graph.landmarks).copy()
    full_pose_mask = _np(graph.pose_mask)
    full_lm_mask = _np(graph.lm_mask)
    full_om = _np(graph.odom.mask)
    full_lm_em = _np(graph.lm_edges.mask)

    for hi in range(window, n + window, window):
        hi = min(hi, n)
        lo = max(hi - window, 0)
        poses = _align_window(poses, landmarks, lo, hi)
        # re-initialize landmarks first seen in this window from their
        # first observation through the re-based (aligned) pose
        fresh = np.nonzero((first_pose >= lo) & (first_pose < hi))[0]
        if fresh.size:
            fe = first_edge[fresh]
            mm = lmeas[fe]
            pt_body = np.stack([mm[:, 0] * np.cos(mm[:, 1]),
                                mm[:, 0] * np.sin(mm[:, 1])], axis=-1)
            landmarks[fresh] = _transform_point(
                poses[lp[fe]], pt_body
            ).astype(landmarks.dtype)
        pose_mask = np.where(np.arange(graph.num_poses) < hi,
                             full_pose_mask, 0.0).astype(np.float32)
        lm_mask = np.where(first_pose < hi, full_lm_mask, 0.0).astype(
            np.float32
        )
        o_mask = (full_om * (oj < hi)).astype(np.float32)
        l_mask = (full_lm_em * (lp < hi)
                  * (lm_mask[ll] > 0)).astype(np.float32)
        g_k = dataclasses.replace(
            base,
            poses=on_dev(poses.astype(np.float32)),
            landmarks=on_dev(landmarks),
            pose_mask=on_dev(pose_mask), lm_mask=on_dev(lm_mask),
            odom=dataclasses.replace(base.odom, mask=on_dev(o_mask)),
            lm_edges=dataclasses.replace(base.lm_edges,
                                         mask=on_dev(l_mask)),
        )
        r = gn.optimize(g_k)
        opt_poses = _np(r.graph.poses).astype(np.float64)
        poses[:hi] = opt_poses[:hi]
        landmarks = _np(r.graph.landmarks).copy()
        if hi < n:
            # dead-reckon the NEXT window from the optimized prefix end
            nxt = min(hi + window, n)
            for p_ in range(hi, nxt):
                poses[p_] = _compose(poses[p_ - 1], meas_row[p_ - 1])
    return graph.with_state(on_dev(poses.astype(np.float32)),
                            on_dev(landmarks))


def coarse_to_fine_init(
    graph: FactorGraph2D,
    factor: int = 16,
    coarse_cfg: OptimizerConfig | None = None,
) -> FactorGraph2D:
    """One coarse solve + prolongation; returns the initialized graph.

    ``coarse_cfg`` defaults to the tuned truncated-Newton schedule on the
    grid solver (the decimated problem is chain + duplicate-free by
    construction only if no two same-segment observations of one landmark
    exist — they generally DO exist, so the general ``schur`` path is the
    default; it sums duplicates correctly).
    """
    if coarse_cfg is None:
        coarse_cfg = OptimizerConfig(
            iterations=40, lr=1.0, solver="schur",
            exact_odom_jacobians=True, pcg_tol=1e-2, pcg_max_iters=60,
            pcg_restart_every=60, pcg_precond="tridiag+coarse",
            pcg_coarse_group=32, pcg_precond_refresh=5,
            convergence_eps=1e-4,
        )
    from toyslam_torch.optimizer.gauss_newton import GaussNewton

    coarse, rel_dr = decimate(graph, factor)
    result = GaussNewton(coarse_cfg).optimize(coarse)
    return prolong(graph, result.graph, rel_dr, factor)
