"""Banded low-rank structure for the streamed fused PCG at scale.

The fused Schur operator (``ops/fused_pcg.py``) writes the landmark fill as
``V V^T`` with ``V = Hpl L^{-T}``.  At 10k poses V is 2.4 GB dense but
almost all zero, with structure: observations are local, so each
landmark's observing poses form a few short runs.  This module finds that
structure on the host, once per graph structure, and fixes a static layout
the band kernel streams:

* chunks index the landmark space: chunk ``c`` owns the ``B`` landmarks
  ``order[c*B:(c+1)*B]`` in first-observation order;
* per chunk, the observation runs of its landmarks are clustered into at
  most ``K`` row-windows of width ``Wrow`` anchored at multiples of 128;
  landmarks that do not fit spill to a few full-height "wide" columns;
* the per-edge scatter index into the tile stack
  ``[n_chunks, K, dp, Wrow, B*dl]`` is precomputed.

``(B, K, Wrow)`` is chosen from a fixed candidate table by a modeled
per-matvec stream time.  The layout is the JAX package's
(``toyslam_tpu.ops.band_plan``) field for field, including the score's
constants, which are fits on a TPU v5e.  One field is added for the CUDA
kernel: ``cover``, the windows covering each pose, in (chunk, window)
order.  :class:`GridBandAux` re-addresses the layout to the pose-major grid
storage of ``ops/grid_schur.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from toyslam_torch.models.graph import TensorTree


@dataclasses.dataclass(frozen=True)
class BandAux(TensorTree):
    """Static banded layout (host-built, structure only); on ``plan.band``
    its presence opens the streamed fused path."""

    # flat index into the [n_chunks * K * dp * Wrow * B*dl] tile stack of
    # the (a=0, b=0) element of each landmark edge's block (0 if not band)
    scatter_base: torch.Tensor   # int64[E]
    band_mask: torch.Tensor      # f32[E] 1 = edge lives in the tile stack
    win_off: torch.Tensor        # int32[n_chunks, K] window start pose
    wide_idx: torch.Tensor       # int64[E] wide-column slot of the edge's lm
    wide_mask: torch.Tensor      # f32[E] 1 = edge belongs to a wide landmark
    # tile materialization: one gather of the band edges' blocks
    # (``src_edges``, base-sorted) and one indexed write at ``elem_ids``
    # (edge-major, collision-free by construction)
    src_edges: torch.Tensor      # int64[Eb]
    elem_ids: torch.Tensor       # int64[Eb * dp * dl]
    # the wide-landmark edges, padded with E (masked out)
    wide_edges: torch.Tensor     # int64[Ew_pad]
    # per pose, the offset of each covering window's row in the kernel's
    # [n_chunks, K, dp, Wrow] partial-output buffer (component 0), in
    # (chunk, window) order; -1 pads
    cover: torch.Tensor          # int32[N, cap]
    chunk_b: int = 64
    k_windows: int = 2
    w_row: int = 192
    n_chunks: int = 0
    n_wide: int = 0
    # block geometry the layout was built for: (3, 2) = SE(2)
    dp: int = 3
    dl: int = 2

    @property
    def tile_bytes(self) -> int:
        b_dl = self.chunk_b * self.dl
        return (self.n_chunks * self.k_windows * self.dp * self.w_row
                * b_dl * 4)


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _window_cover(win_off: np.ndarray, n: int, w_row: int,
                  dp: int) -> np.ndarray:
    """For each pose p < n, the offsets ``((c*K + k)*dp)*Wrow + (p - off)``
    of the windows (c, k) whose rows cover it, in (c, k) order: the band
    kernel's fixed summation order for the w-pass (the reference adds the
    windows into its accumulator in that order)."""
    offs = win_off.reshape(-1).astype(np.int64)
    w = np.arange(w_row, dtype=np.int64)
    pose = offs[:, None] + w[None, :]                       # [n_ck, Wrow]
    base = (np.arange(offs.size, dtype=np.int64)[:, None] * dp) * w_row \
        + w[None, :]
    ok = pose < n
    pose, base = pose[ok], base[ok]
    order = np.argsort(pose, kind="stable")   # keeps (c, k) order per pose
    ps, bs = pose[order], base[order]
    counts = np.bincount(ps, minlength=n)
    cap = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.searchsorted(ps, np.arange(n))
    slot = np.arange(ps.size) - starts[ps]
    cover = np.full((n, cap), -1, np.int64)
    cover[ps, slot] = bs
    return cover


def band_aux_from_arrays(
    device, *, scatter_base, band_mask, win_off, wide_idx, wide_mask,
    src_edges, elem_ids, wide_edges, n, **static,
) -> BandAux:
    """A ``BandAux`` on ``device`` from host arrays (this module's search
    or another package's layout) and its static sizes; the kernel's cover
    table is derived from ``win_off`` for ``n`` poses."""

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return BandAux(
        scatter_base=i64(scatter_base), band_mask=f32(band_mask),
        win_off=i32(win_off), wide_idx=i64(wide_idx),
        wide_mask=f32(wide_mask), src_edges=i64(src_edges),
        elem_ids=i64(elem_ids), wide_edges=i64(wide_edges),
        cover=i32(_window_cover(np.asarray(win_off), n, static["w_row"],
                                static["dp"])),
        **static,
    )


@dataclasses.dataclass(frozen=True)
class GridBandAux(TensorTree):
    """The band layout re-addressed to the pose-major grid storage of
    ``ops/grid_schur.py``: the tile write sources the flattened ``[N*Kp,
    dp, dl]`` per-slot blocks instead of per-edge ones, so the band
    operator builds straight from the grid assembly
    (``fused_pcg.build_band_operator_grid``).  SE(2) only, as the grid
    solver."""

    src_rows: torch.Tensor     # int64[Eb] grid slot per band edge, base-sorted
    elem_ids: torch.Tensor     # int64[Eb*dp*dl] edge-major tile element ids
    wide_slots: torch.Tensor   # int64[Ew_pad] grid slot of each wide edge
    wide_ids: torch.Tensor     # int64[Ew_pad] destination p*n_wide + widx
    win_off: torch.Tensor      # int32[n_chunks, K]
    cover: torch.Tensor        # int32[N, cap], as BandAux.cover
    chunk_b: int = 64
    k_windows: int = 2
    w_row: int = 192
    n_chunks: int = 0
    n_wide: int = 0
    dp: int = 3
    dl: int = 2

    @property
    def tile_bytes(self) -> int:
        return (self.n_chunks * self.k_windows * self.dp * self.w_row
                * self.chunk_b * self.dl * 4)


def build_grid_band(graph, p_pose, p_lm, p_mask,
                    kp: int) -> GridBandAux | None:
    """Host side: the band structure search (:func:`build_band_aux`), its
    tile program re-addressed to pose-major grid slots (slot ``p*kp + q``
    of pose ``p``), and the kernel's cover table.  ``p_pose``, ``p_lm``,
    ``p_mask``: the grid plan's pose-major slot arrays (numpy)."""
    band = build_band_aux(graph)
    if band is None:
        return None
    n = graph.num_poses
    lp = _host(graph.lm_edges.pose).astype(np.int64)
    ll = _host(graph.lm_edges.lm).astype(np.int64)
    # (pose, landmark) -> grid slot; pairs are unique (build_band_aux
    # refuses duplicates)
    key_w = int(max(ll.max(), np.max(p_lm)) + 1)
    slots = np.nonzero(np.asarray(p_mask) > 0)[0]
    keys = np.asarray(p_pose, np.int64)[slots] * key_w + \
        np.asarray(p_lm, np.int64)[slots]
    order = np.argsort(keys, kind="stable")
    skeys, sslots = keys[order], slots[order]

    def slot_of(edges):
        k = lp[edges] * key_w + ll[edges]
        i = np.searchsorted(skeys, k)
        assert np.array_equal(skeys[np.minimum(i, skeys.size - 1)], k)
        return sslots[i].astype(np.int64)

    band_mask = _host(band.band_mask)
    base = _host(band.scatter_base).astype(np.int64)
    stride_a = band.w_row * band.chunk_b * 2
    eb = np.nonzero(band_mask > 0)[0]
    # base-sorted edge order, as the per-edge layout
    order_e = np.argsort(base[eb], kind="stable")
    src_rows = slot_of(eb[order_e])
    offs = np.asarray([a * stride_a + b for a in range(3) for b in range(2)],
                      np.int64)
    elem_ids = (base[eb][order_e][:, None] + offs[None, :]).reshape(-1)

    we = np.nonzero(_host(band.wide_mask) > 0)[0]
    ew_pad = max(64, 1 << int(np.ceil(np.log2(max(len(we), 1)))))
    nw = max(band.n_wide, 1)
    wide_slots = np.full((ew_pad,), n * kp, np.int64)
    wide_ids = np.full((ew_pad,), n * nw, np.int64)
    wide_slots[: len(we)] = slot_of(we)
    wide_ids[: len(we)] = lp[we] * band.n_wide + _host(band.wide_idx)[we]

    dev = graph.device
    return GridBandAux(
        src_rows=torch.as_tensor(src_rows, device=dev),
        elem_ids=torch.as_tensor(elem_ids, device=dev),
        wide_slots=torch.as_tensor(wide_slots, device=dev),
        wide_ids=torch.as_tensor(wide_ids, device=dev),
        win_off=band.win_off, cover=band.cover,
        chunk_b=band.chunk_b, k_windows=band.k_windows, w_row=band.w_row,
        n_chunks=band.n_chunks, n_wide=band.n_wide,
    )


def _runs(poses: np.ndarray, gap: int = 8):
    """Sorted observation poses -> list of [lo, hi] run intervals."""
    iv = []
    lo = hi = int(poses[0])
    for p in poses[1:]:
        p = int(p)
        if p - hi > gap:
            iv.append((lo, hi))
            lo = p
        hi = p
    iv.append((lo, hi))
    return iv


def _try_layout(n, obs_by_lm, first_obs, order, B, K, Wrow, spill_cap):
    """Greedy layout attempt; returns (win_off, col_of, wide_lms) or
    None if more than ``spill_cap`` landmarks spill.

    Chunk ``c`` owns landmarks ``order[c*B : (c+1)*B]`` (first-observation
    order, so a chunk's landmarks share observation windows);
    ``col_of[lm] = (chunk, slot)``."""
    m_real = len(order)
    n_chunks = max(1, -(-m_real // B))
    win_off = np.zeros((n_chunks, K), np.int64)
    col_of = {}
    wide = []
    for c in range(n_chunks):
        lms = order[c * B: (c + 1) * B]
        ivs = []
        for m in lms:
            for lo, hi in _runs(obs_by_lm[m]):
                ivs.append((lo, hi, m))
        ivs.sort()
        wins = []          # window anchor poses (128-aligned)
        bad = set()
        for lo, hi, m in ivs:
            placed = False
            for wv in wins:
                if wv[0] <= lo and hi < wv[0] + Wrow:
                    placed = True
                    break
            if placed:
                continue
            lo_q = (lo // 128) * 128
            if len(wins) < K and hi - lo_q < Wrow:
                wins.append([lo_q])
                continue
            bad.add(m)
        for slot, m in enumerate(lms):
            if m in bad:
                wide.append(m)
            else:
                col_of[m] = (c, slot)
        if len(wide) > spill_cap:
            return None
        for k, wv in enumerate(wins):
            win_off[c, k] = wv[0]
        for k in range(len(wins), K):
            win_off[c, k] = win_off[c, max(len(wins) - 1, 0)]
    if len(wide) > spill_cap:
        return None
    return win_off, col_of, wide


_SEARCH_DL2 = (
    (64, 2, 256), (64, 3, 256), (64, 4, 256), (64, 3, 384),
    (64, 4, 384), (128, 2, 256), (128, 3, 256), (128, 4, 256),
    (128, 3, 384), (128, 4, 384), (64, 6, 256),
    (64, 8, 256), (64, 6, 384), (64, 10, 256), (64, 12, 256),
    (64, 2, 768), (128, 2, 896), (64, 12, 384), (128, 6, 256),
    (128, 8, 256),
    (64, 2, 512), (128, 2, 512), (256, 2, 512), (128, 2, 768),
    (256, 2, 768), (192, 2, 768), (128, 3, 512), (256, 3, 512),
    (256, 4, 384), (192, 2, 512), (128, 10, 256), (128, 6, 512),
)
# dl=3 (SE(3)/BA): B*dl a multiple of 128, so B in {128, 256}
_SEARCH_DL3 = (
    (128, 2, 128), (128, 2, 256), (128, 3, 128), (128, 3, 256),
    (128, 2, 384), (128, 4, 128), (128, 4, 256), (256, 2, 128),
    (256, 2, 256), (128, 3, 384),
)

# the layout score's constants: a TPU v5e's measured tile-stream rate and
# in-kernel cost per (chunk, window); kept so the layout is the JAX
# package's and the two packages stay comparable (ROADMAP.md A.9)
_STREAM_BW = 855e9
_C_WIN = 0.44e-6


def _dense_streamed_layout(
    graph, dp: int, dl: int, max_bytes: int = 4 << 30,
) -> BandAux | None:
    """Degenerate band layout: ONE full-height window, landmark-chunked
    columns — the tile stack is the dense V in chunk-blocked form, streamed
    by the unchanged band kernel.  For graphs without run-local structure
    (ring-camera BA); gated by ``max_bytes``."""
    n, m = graph.num_poses, graph.num_landmarks
    b = 128 if (64 * dl) % 128 else 64
    w_row = -(-n // 128) * 128
    n_chunks = -(-m // b)
    b_dl = b * dl
    if n_chunks * dp * w_row * b_dl * 4 > max_bytes:
        return None
    lp = _host(graph.lm_edges.pose)
    ll = _host(graph.lm_edges.lm)
    msk = _host(graph.lm_edges.mask) > 0
    e_all = lp.shape[0]
    real = np.nonzero(msk)[0]
    if real.size == 0:
        return None
    pair_key = lp[real].astype(np.int64) * np.int64(ll.max() + 1) + ll[real]
    if np.unique(pair_key).shape[0] != real.shape[0]:
        return None
    stride_a = w_row * b_dl
    c = ll[real].astype(np.int64) // b
    slot = ll[real].astype(np.int64) - c * b
    scatter_base = np.zeros(e_all, np.int64)
    scatter_base[real] = (
        (c * dp + 0) * stride_a + lp[real].astype(np.int64) * b_dl
        + slot * dl
    )
    band_mask = np.zeros(e_all, np.float32)
    band_mask[real] = 1.0
    offs = np.asarray(
        [a * stride_a + bb for a in range(dp) for bb in range(dl)],
        np.int64,
    )
    order = np.argsort(scatter_base[real], kind="stable")
    src_edges = real[order]
    elem_ids = (
        scatter_base[src_edges][:, None] + offs[None, :]
    ).reshape(-1)
    return band_aux_from_arrays(
        graph.device, n=n,
        scatter_base=scatter_base, band_mask=band_mask,
        win_off=np.zeros((n_chunks, 1), np.int32),
        wide_idx=np.zeros(e_all, np.int64),
        wide_mask=np.zeros(e_all, np.float32),
        src_edges=src_edges, elem_ids=elem_ids,
        wide_edges=np.full((64,), e_all, np.int64),
        chunk_b=b, k_windows=1, w_row=int(w_row),
        n_chunks=int(n_chunks), n_wide=0, dp=dp, dl=dl,
    )


def build_band_aux(
    graph, spill_cap: int = 56, search=None, dp: int = 3, dl: int = 2,
) -> BandAux | None:
    """Host-side structure search.  Returns the dense-streamed degenerate
    layout (:func:`_dense_streamed_layout`) when no searched (B, K, Wrow)
    covers the workload within the spill cap and the dense stack is not
    too large; None otherwise (duplicate (pose, landmark) observations, no
    observations).  ``B*dl`` stays a multiple of 128."""
    if search is None:
        search = _SEARCH_DL2 if dl == 2 else _SEARCH_DL3
    search = tuple(c for c in search if (c[0] * dl) % 128 == 0)
    n = graph.num_poses
    # wide columns are full-height (dp*dl*n*4 bytes each): cap the spill
    # by an ~8 MB budget
    spill_cap = min(
        spill_cap, max(4, (8 << 20) // max(dp * dl * n * 4, 1))
    )
    lp = _host(graph.lm_edges.pose)
    ll = _host(graph.lm_edges.lm)
    msk = _host(graph.lm_edges.mask) > 0
    e_all = lp.shape[0]
    if not msk.any():
        return None
    real = np.nonzero(msk)[0]
    # duplicate (pose, lm) observations would share one tile slot, and the
    # indexed write would drop one block: refuse the layout
    pair_key = lp[real].astype(np.int64) * np.int64(ll.max() + 1) + ll[real]
    if np.unique(pair_key).shape[0] != real.shape[0]:
        return None
    order_e = real[np.lexsort((lp[real], ll[real]))]
    lms, starts = np.unique(ll[order_e], return_index=True)
    obs_by_lm = {}
    first_obs = {}
    for i, m in enumerate(lms):
        seg = order_e[starts[i]: starts[i + 1] if i + 1 < len(lms)
                      else None]
        ps = np.sort(lp[seg])
        obs_by_lm[int(m)] = ps
        first_obs[int(m)] = int(ps[0])
    order = sorted(obs_by_lm, key=lambda m: first_obs[m])

    cands = []
    for B, K, Wrow in search:
        got = _try_layout(n, obs_by_lm, first_obs, order, B, K, Wrow,
                          spill_cap)
        if got is None:
            continue
        bytes_ = (-(-len(order) // B)) * K * dp * Wrow * (B * dl) * 4
        cands.append((bytes_, B, K, Wrow, got))
    if not cands:
        # no run-local structure: stream dense V
        return _dense_streamed_layout(graph, dp, dl)
    # modeled per-matvec stream time: bytes / rate + windows * cost
    m_real = len(order)

    def _score(c):
        bytes_, B, K, _, _ = c
        return bytes_ / _STREAM_BW + (-(-m_real // B)) * K * _C_WIN

    _, B, K, Wrow, (win_off, col_of, wide) = min(cands, key=_score)
    n_chunks = max(1, -(-m_real // B))
    b_dl = B * dl

    wide_slot = {int(m): i for i, m in enumerate(sorted(wide))}
    n_wide = len(wide)

    scatter_base = np.zeros(e_all, np.int64)
    band_mask = np.zeros(e_all, np.float32)
    wide_idx = np.zeros(e_all, np.int64)
    wide_mask = np.zeros(e_all, np.float32)
    for e in real:
        m = int(ll[e])
        p = int(lp[e])
        if m in wide_slot:
            wide_idx[e] = wide_slot[m]
            wide_mask[e] = 1.0
            continue
        cs = col_of.get(m)
        if cs is None:
            continue
        c, slot = cs
        k_found = -1
        for k in range(K):
            off = int(win_off[c, k])
            if off <= p < off + Wrow:
                k_found = k
                break
        assert k_found >= 0, (m, p, c, win_off[c])
        # flat index of (c, k, a=0, p-off, slot*dl+b=0) in
        # [n_chunks, K, dp, Wrow, B*dl]
        scatter_base[e] = (
            (((c * K + k_found) * dp + 0) * Wrow
             + (p - int(win_off[c, k_found])))
            * b_dl + slot * dl
        )
        band_mask[e] = 1.0

    # (band edge, a, b) -> destination tile slot, sorted by destination;
    # slots are unique, so an indexed write holds exactly the sum
    eb = np.nonzero(band_mask > 0)[0]
    stride_a = Wrow * b_dl
    offs = np.asarray(
        [a * stride_a + b for a in range(dp) for b in range(dl)], np.int64
    )
    order_e = np.argsort(scatter_base[eb], kind="stable")
    src_edges = eb[order_e]
    elem_ids = (
        scatter_base[src_edges][:, None] + offs[None, :]
    ).reshape(-1)

    we = np.nonzero(wide_mask > 0)[0]
    ew_pad = max(64, 1 << int(np.ceil(np.log2(max(len(we), 1)))))
    wide_edges = np.full((ew_pad,), e_all, np.int64)
    wide_edges[: len(we)] = we

    return band_aux_from_arrays(
        graph.device, n=n,
        scatter_base=scatter_base, band_mask=band_mask, win_off=win_off,
        wide_idx=wide_idx, wide_mask=wide_mask, src_edges=src_edges,
        elem_ids=elem_ids, wide_edges=wide_edges,
        chunk_b=B, k_windows=K, w_row=Wrow,
        n_chunks=n_chunks, n_wide=n_wide, dp=dp, dl=dl,
    )
