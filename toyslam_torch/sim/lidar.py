"""2D LiDAR against circular obstacles (host numpy, float64).

Semantics: ray-circle intersection by the discriminant test, then the
smallest non-negative root; the measured bearing is the bearing of the hit
obstacle's *center* (the upstream simulator's quirk), the measured range is
the ray root; association is by ground-truth obstacle id.
"""

from __future__ import annotations

import numpy as np

BIG = 1e9


def scan_trajectory_np(
    poses, env, radius: float, fov: float, ray_count: int
):
    """Scan from every pose at once, vectorized over ``[T, R, P]``.

    Float64 keeps grazing rays on the same side of the ``d2 <= r^2``
    decision boundary on every platform, so hit ids, and hence the problem
    instance, do not depend on the machine.  Returns ``(meas [T, R, 2]
    float32 (range, bearing), ids [T, R] int32, valid [T, R] bool)``.
    """
    poses = np.asarray(poses, np.float64)       # [T,3]
    env = np.asarray(env, np.float64)           # [P,2]
    origin = poses[:, :2]                       # [T,2]
    theta = poses[:, 2]                         # [T]
    rel = np.linspace(-0.5 * fov, 0.5 * fov, ray_count)
    ang = theta[:, None] + rel[None, :]         # [T,R]
    dirs = np.stack([np.cos(ang), np.sin(ang)], axis=-1)  # [T,R,2]

    oc = env[None, :, :] - origin[:, None, :]   # [T,P,2]
    tca = np.einsum("trd,tpd->trp", dirs, oc)   # [T,R,P]
    d2 = np.sum(oc * oc, axis=-1)[:, None, :] - tca**2
    r2 = radius * radius
    thc = np.sqrt(np.maximum(r2 - d2, 0.0))
    t0, t1 = tca - thc, tca + thc
    t = np.where(t0 < 0.0, t1, t0)
    hit = (d2 <= r2) & (t1 >= 0.0)
    t = np.where(hit, t, BIG)

    best = np.argmin(t, axis=2)                               # [T,R]
    t_best = np.take_along_axis(t, best[..., None], axis=2)[..., 0]
    valid = t_best < BIG

    centers = env[best]                                       # [T,R,2]
    to_c = centers - origin[:, None, :]
    bearing = np.arctan2(to_c[..., 1], to_c[..., 0]) - theta[:, None]
    bearing = np.arctan2(np.sin(bearing), np.cos(bearing))
    meas = np.stack([t_best, bearing], axis=-1)
    meas = np.where(valid[..., None], meas, 0.0).astype(np.float32)
    ids = np.where(valid, best, -1).astype(np.int32)
    return meas, ids, valid
