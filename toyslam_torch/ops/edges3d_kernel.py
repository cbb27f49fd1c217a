"""The SE(3) edges of the assembly and of the step rejection's chi^2 in two
launches of hand-written kernels (``csrc/edges3d.cu``): one for the
relative-pose edges, one for the reprojection edges.

:func:`edge_blocks` gives what ``edge_blocks3d.odom3d_edge_blocks`` and
``edge_blocks3d.reproj_edge_blocks`` give (residuals, forward-mode
relative-pose Jacobians or ``A = -I, B = I``, Huber weights and the
per-edge normal-equation blocks); :func:`edge_errors` the per-edge robust
chi^2 of ``residuals3d.eval_odom3d_edges`` (without Jacobians) and
``residuals3d.eval_reproj_edges``.  Those batched formulas are the plain
version: ``schur3d`` takes the kernels for tensors on the card and the
plain version on the CPU, as ``schur.build_tridiag_planes`` does for the
PCR kernel.  The sums over edges stay with the caller (the gather tables,
``.sum()``).

:func:`odom_blocks`, :func:`reproj_blocks`, :func:`odom_errors` and
:func:`reproj_errors` are one launch each; :func:`edge_blocks` and
:func:`edge_errors` pair them.  Every entry point takes the graph's
tensors as they lie (float32, contiguous, int64 indices, one CUDA device)
and raises on anything else: float64 on the card is refused, not
evaluated by other means.  Each launch counts in ``launches``: two an
assembly, two a chi^2.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from toyslam_torch.ops.edge_blocks3d import OdomBlocks, ReprojBlocks

# launches of either kernel since import (chip_smoke.py resets and reads it)
launches = 0

# the relative-pose kernel's modes (csrc/edges3d.cu)
_RESIDUALS, _BLOCKS_FIXED, _BLOCKS_EXACT = 0, 1, 2
# edges3d_attrs's instantiations
INSTANTIATIONS = ("odom_residuals", "odom_blocks_fixed", "odom_blocks_exact",
                  "reproj_residuals", "reproj_blocks")


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' shared library (built at first use), with its C
    signatures declared."""
    from toyslam_torch import kernels

    lib = kernels.load("edges3d").lib
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.edges3d_attrs.argtypes = [ci, ctypes.POINTER(ctypes.c_longlong)]
    lib.edges3d_attrs.restype = ci
    lib.edges3d_odom_launch.argtypes = [ci, ci, ci] + [vp] * 6 + [cd] + [vp] * 9
    lib.edges3d_odom_launch.restype = ci
    lib.edges3d_reproj_launch.argtypes = ([ci] * 5 + [vp] * 8 + [cd]
                                          + [vp] * 8)
    lib.edges3d_reproj_launch.restype = ci
    return lib


def kernel_attrs() -> dict:
    """Each instantiation as the card compiled it: its registers a thread
    and its local memory a thread (spilled registers)."""
    out = {}
    for k, name in enumerate(INSTANTIATIONS):
        vals = (ctypes.c_longlong * 2)()
        err = _library().edges3d_attrs(k, vals)
        if err != 0:
            raise RuntimeError(f"edges3d_attrs failed: cudaError_t {err}")
        out[name] = {"registers": vals[0], "local_bytes": vals[1]}
    return out


def _check(poses, **tensors) -> None:
    """Raise unless ``poses`` and each ``name=(tensor, shape)`` are what
    the kernels read: that shape, float32 (int64 for the indices),
    contiguous, on the poses' CUDA device."""
    for name, (t, want) in dict(poses=(poses, (poses.shape[0], 12)),
                                **tensors).items():
        if tuple(t.shape) != want:
            raise ValueError(f"edges3d: {name} of shape {tuple(t.shape)}, "
                             f"the kernel takes {want}")
        dtype = torch.int64 if name in _INDICES else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"edges3d: {name} of dtype {t.dtype}, the "
                            f"kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"edges3d: {name} is not contiguous; the "
                             "kernel reads the rows as stored")
        if t.device != poses.device:
            raise ValueError(f"edges3d: {name} on {t.device}, poses on "
                             f"{poses.device}")
    if poses.device.type != "cuda":
        raise ValueError(f"edges3d: no kernel for {poses.device}")


_INDICES = ("odom_i", "odom_j", "lm_pose", "lm_lm")


def _odom_tensors(odom) -> dict:
    e = odom.i.shape[0]
    return dict(odom_i=(odom.i, (e,)), odom_j=(odom.j, (e,)),
                odom_meas=(odom.meas, (e, 12)),
                odom_info=(odom.info, (e, 6, 6)), odom_mask=(odom.mask, (e,)))


def _reproj_tensors(landmarks, intrinsics, lm_edges) -> dict:
    if intrinsics.dim() != 1 or intrinsics.shape[0] not in (4, 5):
        raise ValueError(f"edges3d: intrinsics of shape "
                         f"{tuple(intrinsics.shape)}; the kernel takes [4] "
                         "(fx, fy, cx, cy) or [5] (+ near plane)")
    e = lm_edges.pose.shape[0]
    return dict(landmarks=(landmarks, (landmarks.shape[0], 3)),
                intrinsics=(intrinsics, (intrinsics.shape[0],)),
                lm_pose=(lm_edges.pose, (e,)), lm_lm=(lm_edges.lm, (e,)),
                lm_meas=(lm_edges.meas, (e, 2)),
                lm_info=(lm_edges.info, (e, 2, 2)),
                lm_mask=(lm_edges.mask, (e,)))


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _ptrs(outs) -> list:
    return [t.data_ptr() if t is not None else None for t in outs]


def _empty(like, *shape):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def _odom_launch(mode, poses, odom, huber_delta, robust_err, blocks=None,
                 jacobians=(None, None)) -> None:
    global launches
    if odom.i.shape[0] == 0:
        return
    err = _library().edges3d_odom_launch(
        mode, poses.shape[0], odom.i.shape[0], poses.data_ptr(),
        odom.i.data_ptr(), odom.j.data_ptr(), odom.meas.data_ptr(),
        odom.info.data_ptr(), odom.mask.data_ptr(), float(huber_delta),
        robust_err.data_ptr(),
        *_ptrs(blocks[:5] if blocks is not None else (None,) * 5),
        *_ptrs(jacobians), _stream(poses.device))
    if err != 0:
        raise RuntimeError(f"edges3d relative-pose launch failed: "
                           f"cudaError_t {err}")
    launches += 1


def _reproj_launch(poses, landmarks, intrinsics, lm_edges, huber_delta,
                   robust_err, blocks=None) -> None:
    global launches
    if lm_edges.pose.shape[0] == 0:
        return
    outs = ((blocks.chi2, blocks.w_ata, blocks.w_btb, blocks.w_hpl,
             blocks.bp_c, blocks.bl_c) if blocks is not None
            else (None,) * 6)
    err = _library().edges3d_reproj_launch(
        int(blocks is not None), poses.shape[0], landmarks.shape[0],
        intrinsics.shape[0], lm_edges.pose.shape[0], poses.data_ptr(),
        landmarks.data_ptr(), intrinsics.data_ptr(),
        lm_edges.pose.data_ptr(), lm_edges.lm.data_ptr(),
        lm_edges.meas.data_ptr(), lm_edges.info.data_ptr(),
        lm_edges.mask.data_ptr(), float(huber_delta), robust_err.data_ptr(),
        *_ptrs(outs), _stream(poses.device))
    if err != 0:
        raise RuntimeError(f"edges3d reprojection launch failed: "
                           f"cudaError_t {err}")
    launches += 1


def _new_odom_blocks(poses, e) -> OdomBlocks:
    return OdomBlocks(w_aa=_empty(poses, e, 6, 6), w_bb=_empty(poses, e, 6, 6),
                      w_ab=_empty(poses, e, 6, 6), b_a=_empty(poses, e, 6),
                      b_b=_empty(poses, e, 6), robust_err=_empty(poses, e))


def odom_blocks(poses, odom, huber_delta: float,
                exact: bool = False) -> OdomBlocks:
    """The per-edge blocks of every relative-pose edge (``odom``, a
    ``graph3d.Odom3DEdges``; with ``exact`` the forward-mode Jacobians,
    else ``A = -I, B = I``), in one launch on the current stream."""
    _check(poses, **_odom_tensors(odom))
    ob = _new_odom_blocks(poses, odom.i.shape[0])
    _odom_launch(_BLOCKS_EXACT if exact else _BLOCKS_FIXED, poses, odom,
                 huber_delta, ob.robust_err, ob)
    return ob


def reproj_blocks(poses, landmarks, intrinsics, lm_edges,
                  huber_delta: float) -> ReprojBlocks:
    """The per-edge blocks of every reprojection edge (``lm_edges``, a
    ``graph3d.ReprojEdges``), in one launch on the current stream."""
    _check(poses, **_reproj_tensors(landmarks, intrinsics, lm_edges))
    e = lm_edges.pose.shape[0]
    rb = ReprojBlocks(w_ata=_empty(poses, e, 6, 6),
                      w_btb=_empty(poses, e, 3, 3),
                      w_hpl=_empty(poses, e, 6, 3), bp_c=_empty(poses, e, 6),
                      bl_c=_empty(poses, e, 3), robust_err=_empty(poses, e),
                      chi2=_empty(poses, e))
    _reproj_launch(poses, landmarks, intrinsics, lm_edges, huber_delta,
                   rb.robust_err, rb)
    return rb


def odom_errors(poses, odom, huber_delta: float) -> torch.Tensor:
    """The per-edge robust chi^2 (masked) ``[E]`` of the relative-pose
    edges, in one launch on the current stream: residuals only, no
    Jacobians."""
    _check(poses, **_odom_tensors(odom))
    out = _empty(poses, odom.i.shape[0])
    _odom_launch(_RESIDUALS, poses, odom, huber_delta, out)
    return out


def reproj_errors(poses, landmarks, intrinsics, lm_edges,
                  huber_delta: float) -> torch.Tensor:
    """The per-edge robust chi^2 (masked) ``[E]`` of the reprojection
    edges, in one launch on the current stream."""
    _check(poses, **_reproj_tensors(landmarks, intrinsics, lm_edges))
    out = _empty(poses, lm_edges.pose.shape[0])
    _reproj_launch(poses, landmarks, intrinsics, lm_edges, huber_delta, out)
    return out


def _check_all(poses, landmarks, intrinsics, odom, lm_edges) -> None:
    # both edge kinds before either launch: a refusal launches nothing
    _check(poses, **_odom_tensors(odom),
           **_reproj_tensors(landmarks, intrinsics, lm_edges))


def edge_blocks(poses, landmarks, intrinsics, odom, lm_edges,
                huber_delta: float, exact: bool = False,
                ) -> tuple[OdomBlocks, ReprojBlocks]:
    """:func:`odom_blocks` and :func:`reproj_blocks`: the per-edge blocks
    of every SE(3) edge, in two launches."""
    _check_all(poses, landmarks, intrinsics, odom, lm_edges)
    return (odom_blocks(poses, odom, huber_delta, exact=exact),
            reproj_blocks(poses, landmarks, intrinsics, lm_edges,
                          huber_delta))


def edge_errors(poses, landmarks, intrinsics, odom, lm_edges,
                huber_delta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`odom_errors` and :func:`reproj_errors`: the per-edge robust
    chi^2 of every SE(3) edge, ``[E1]`` and ``[E2]``, in two launches."""
    _check_all(poses, landmarks, intrinsics, odom, lm_edges)
    return (odom_errors(poses, odom, huber_delta),
            reproj_errors(poses, landmarks, intrinsics, lm_edges,
                          huber_delta))


def odom_jacobians(poses, odom, huber_delta: float,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward-mode Jacobians ``JA, JB [E, 6, 6]`` of the relative-pose
    edges that the assembly's launch forms its blocks from (one launch,
    which also writes the blocks): the kernel's side of the comparison
    with ``torch.func.jacfwd``."""
    _check(poses, **_odom_tensors(odom))
    e = odom.i.shape[0]
    ja, jb = _empty(poses, e, 6, 6), _empty(poses, e, 6, 6)
    ob = _new_odom_blocks(poses, e)
    _odom_launch(_BLOCKS_EXACT, poses, odom, huber_delta, ob.robust_err, ob,
                 (ja, jb))
    return ja, jb
