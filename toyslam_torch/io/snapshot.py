"""Graph checkpoint / resume.

A snapshot is a single ``.npz`` holding the exact padded arrays of a
:class:`FactorGraph2D` (masks, fixed flags and bucketing included, so a
reload gives a bit-identical graph of the same shapes) plus a JSON metadata
blob (config, iteration counters, chi^2 history: whatever the caller wants
to carry).  The file layout is that of ``toyslam_tpu.io.snapshot`` (format
version 1); only the index dtype differs (int64 here).  For interchange
with other consumers use ``io.codec.graph_to_bytes``; that format is lossy
only in padding.

:func:`save_snapshot` reads the graph back from whatever device it is on;
:func:`load_snapshot` returns CPU tensors, which the caller moves.
"""

from __future__ import annotations

import json
from typing import Any, Optional

import numpy as np
import torch

from toyslam_torch.models.graph import (
    FactorGraph2D,
    LandmarkEdges,
    OdomEdges,
    to_numpy as _np,
)

_FORMAT_VERSION = 1


def save_snapshot(
    path: str,
    graph: FactorGraph2D,
    metadata: Optional[dict[str, Any]] = None,
) -> None:
    """Write the graph (and optional metadata dict) to ``path`` (.npz)."""
    np.savez_compressed(
        path,
        __version__=np.int32(_FORMAT_VERSION),
        __metadata__=np.frombuffer(
            json.dumps(metadata or {}).encode(), np.uint8
        ),
        poses=_np(graph.poses),
        landmarks=_np(graph.landmarks),
        pose_mask=_np(graph.pose_mask),
        lm_mask=_np(graph.lm_mask),
        pose_fixed=_np(graph.pose_fixed),
        lm_fixed=_np(graph.lm_fixed),
        odom_i=_np(graph.odom.i),
        odom_j=_np(graph.odom.j),
        odom_meas=_np(graph.odom.meas),
        odom_info=_np(graph.odom.info),
        odom_mask=_np(graph.odom.mask),
        lm_pose=_np(graph.lm_edges.pose),
        lm_lm=_np(graph.lm_edges.lm),
        lm_meas=_np(graph.lm_edges.meas),
        lm_info=_np(graph.lm_edges.info),
        lm_edge_mask=_np(graph.lm_edges.mask),
    )


def load_snapshot(path: str) -> tuple[FactorGraph2D, dict[str, Any]]:
    """Inverse of :func:`save_snapshot`."""
    with np.load(path) as z:
        version = int(z["__version__"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported snapshot version {version}")
        metadata = json.loads(bytes(z["__metadata__"].tobytes()).decode())

        def t(name):
            return torch.from_numpy(z[name])

        def idx(name):
            return torch.from_numpy(z[name].astype(np.int64))

        graph = FactorGraph2D(
            poses=t("poses"),
            landmarks=t("landmarks"),
            pose_mask=t("pose_mask"),
            lm_mask=t("lm_mask"),
            pose_fixed=t("pose_fixed"),
            lm_fixed=t("lm_fixed"),
            odom=OdomEdges(
                i=idx("odom_i"),
                j=idx("odom_j"),
                meas=t("odom_meas"),
                info=t("odom_info"),
                mask=t("odom_mask"),
            ),
            lm_edges=LandmarkEdges(
                pose=idx("lm_pose"),
                lm=idx("lm_lm"),
                meas=t("lm_meas"),
                info=t("lm_info"),
                mask=t("lm_edge_mask"),
            ),
        )
    return graph, metadata
