"""Preliminary relative cameras from tracks: F -> E -> (R, t) per pair
(PyTorch). Counterpart of vggsfm_tpu/twoview/preliminary.py (reference
vggsfm/two_view_geo/estimate_preliminary.py:98-239, :242-271).

Cameras stay in the OpenCV convention; all S-1 (query, frame) pairs run
as one batched LORANSAC.
"""

from __future__ import annotations

import torch

from vggsfm_tpu_torch.geometry.cameras import build_intrinsics
from vggsfm_tpu_torch.twoview.essential import (
    decompose_essential_matrix,
    essential_from_fundamental,
    remove_cheirality,
)
from vggsfm_tpu_torch.twoview.fundamental import estimate_fundamental
from vggsfm_tpu_torch.utils import trace


def default_intrinsics(width: float, height: float, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """(3, 3): f = max(W, H), the principal point at the image centre."""
    focal = float(max(width, height))
    fl = torch.full((2,), focal, dtype=dtype, device=device)
    pp = torch.full((2,), width / 2.0, dtype=dtype, device=device)
    pp[1] = height / 2.0
    return build_intrinsics(fl, pp)


def estimate_preliminary_cameras(tracks: torch.Tensor,
                                 tracks_vis: torch.Tensor, width: int,
                                 height: int,
                                 generator: torch.Generator | None = None,
                                 tracks_score: torch.Tensor | None = None,
                                 max_error: float = 0.5, lo_num: int = 128,
                                 max_ransac_iters: int = 1024,
                                 sample_idx: torch.Tensor | None = None):
    """Relative cameras of every frame with respect to the query frame 0.

    tracks (B, S, N, 2), frame 0 the query frame; tracks_vis (B, S, N) in
    [0, 1]; tracks_score optional (B, S, N) confidence. The RANSAC minimal
    sets are drawn from `generator`, or given as `sample_idx`
    (max_ransac_iters, 7). Runs on the tracks' device.

    Returns a dict: ``extrinsics`` (B, S, 3, 4) world->cam OpenCV, frame 0
    the identity; ``fmat`` (B, S-1, 3, 3); ``fmat_inlier_mask``
    (B, S-1, N); ``fmat_residuals`` (B, S-1, N); ``default_intri`` (3, 3).
    E, its decomposition and the cheirality choice are the tracer's span
    ``preliminary.pose``; the counters ``preliminary.inliers`` and
    ``preliminary.valid`` count the inliers and the usable tracks over
    the pairs.
    """
    B, S, N, _ = tracks.shape
    P = B * (S - 1)
    query = tracks[:, 0:1].expand(B, S - 1, N, 2).reshape(P, N, 2)
    ref = tracks[:, 1:].reshape(P, N, 2)
    valid = (tracks_vis >= 0.05)[:, 1:].reshape(P, N)
    if tracks_score is not None:
        valid = valid & (tracks_score >= 0.5)[:, 1:].reshape(P, N)

    fres = estimate_fundamental(query, ref, generator,
                                max_ransac_iters=max_ransac_iters,
                                max_error=max_error, lo_num=lo_num,
                                valid_mask=valid, sample_idx=sample_idx)
    fmat = fres["fmat"]
    # the inliers over the usable tracks (the inliers are a subset of them)
    trace.count("preliminary.inliers", fres["inlier_mask"])
    trace.count("preliminary.valid", valid)

    with trace.span("preliminary.pose"):
        K = default_intrinsics(width, height, dtype=tracks.dtype,
                               device=tracks.device)
        Kb = K.expand(P, 3, 3)
        Rs, ts = decompose_essential_matrix(
            essential_from_fundamental(fmat, Kb, Kb))
        fl = torch.stack([K[0, 0], K[1, 1], K[0, 0], K[1, 1]]).expand(P, 4)
        pp = torch.stack([K[0, 2], K[1, 2], K[0, 2], K[1, 2]]).expand(P, 4)
        R, t = remove_cheirality(Rs, ts, query, ref, fl, pp)

    rel = torch.cat([R, t[..., None]], dim=-1).reshape(B, S - 1, 3, 4)
    eye = torch.eye(3, 4, dtype=tracks.dtype,
                    device=tracks.device).expand(B, 1, 3, 4)
    return {
        "extrinsics": torch.cat([eye, rel], dim=1),
        "fmat": fmat.reshape(B, S - 1, 3, 3),
        "fmat_inlier_mask": fres["inlier_mask"].reshape(B, S - 1, N),
        "fmat_residuals": fres["residuals"].reshape(B, S - 1, N),
        "default_intri": K,
    }
