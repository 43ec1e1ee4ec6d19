"""Multi-query camera averaging and query-frame ranking (PyTorch).
Counterpart of vggsfm_tpu/utils/camera_avg.py (reference
vggsfm/utils/utils.py:25-164, :234-308).

Rotations are averaged as sign-aligned quaternion means. The ranking runs
on the host in numpy, as the JAX package's farthest-point sampling does.
"""

from __future__ import annotations

import numpy as np
import torch

from vggsfm_tpu_torch.geometry.cameras import (
    pose_encoding_to_extri_intri,
    se3_compose,
    se3_inverse,
)
from vggsfm_tpu_torch.geometry.rotations import (
    matrix_to_quaternion,
    quaternion_to_matrix,
)
from vggsfm_tpu_torch.models.sampling import interpolate_bilinear


def average_rotations(Rs: torch.Tensor) -> torch.Tensor:
    """(Q, N, 3, 3) -> (N, 3, 3): quaternion mean over Q, hemispheres
    aligned to the first prediction."""
    q = matrix_to_quaternion(Rs)
    sign = torch.sign((q * q[0:1]).sum(-1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    mean = (q * sign).mean(0)
    mean = mean / torch.linalg.vector_norm(mean, dim=-1,
                                           keepdim=True).clamp(min=1e-12)
    return quaternion_to_matrix(mean)


def average_camera_prediction(camera_forward, images, image_size,
                              query_indices=None, repeat_times: int = 5,
                              seed: int = 0, model_input_size: int = 336):
    """Ensemble the camera predictor over query orderings.

    All Q orderings run as ONE batched forward: the frames are resized once
    to the predictor's input size and gathered into a (Q, S, h, w, 3)
    batch, ordering q putting query frame `query_indices[q]` first.

    camera_forward: images (Q, S, H, W, 3) -> pose encodings (Q, S, 8).
    images (1, S, H, W, 3); image_size (H, W) of the target camera frame.
    Returns (extrinsics (S, 3, 4), intrinsics (S, 3, 3)) averaged over the
    orderings, relative to frame 0.
    """
    S = images.shape[1]
    if query_indices is None:
        rng = np.random.default_rng(seed)
        query_indices = list(rng.choice(S, size=min(repeat_times, S),
                                        replace=False))
        if 0 not in query_indices:
            query_indices.insert(0, 0)
    orders = []
    for qi in query_indices:
        order = np.arange(S)
        order[0], order[qi] = qi, 0
        orders.append(order)
    orders = np.stack(orders)  # (Q, S)
    Q = orders.shape[0]
    inv_orders = np.argsort(orders, axis=1)

    x = images[0]
    if tuple(x.shape[1:3]) != (model_input_size, model_input_size):
        x = interpolate_bilinear(x, (model_input_size, model_input_size))
    idx = torch.as_tensor(orders.reshape(-1), device=x.device)
    batch = x[idx].reshape(Q, S, *x.shape[1:])
    pose_encs = camera_forward(batch)
    if tuple(pose_encs.shape[:2]) != (Q, S):
        raise ValueError(
            f"camera_forward must return (Q={Q}, S={S}, D) pose encodings "
            f"for a (Q, S, H, W, 3) batch; got {tuple(pose_encs.shape)}")
    inv = torch.as_tensor(inv_orders, device=pose_encs.device)
    return _decode_and_average(pose_encs.float(), inv, tuple(image_size))


def _decode_and_average(pose_encs, inv_orders, image_size):
    """(Q, S, 8) pose encodings + (Q, S) inverse orderings -> averaged
    (extrinsics (S, 3, 4), intrinsics (S, 3, 3)): decode each ordering,
    put its frames back in order, re-relativize to frame 0, then average
    rotations (quaternion mean), translations and focals."""
    extr, intr = pose_encoding_to_extri_intri(pose_encs, image_size)
    Q, S = inv_orders.shape
    gather = inv_orders[..., None, None]
    extr = torch.gather(extr, 1, gather.expand(Q, S, 3, 4))
    intr = torch.gather(intr, 1, gather.expand(Q, S, 3, 3))
    extr = se3_compose(extr, se3_inverse(extr[:, 0])[:, None])
    R = average_rotations(extr[..., :3])
    t = extr[..., 3].mean(0)
    f = torch.stack([intr[..., 0, 0], intr[..., 1, 1]], dim=-1).mean(0)
    H, W = image_size
    intr_out = torch.zeros(S, 3, 3, dtype=R.dtype, device=R.device)
    intr_out[:, 0, 0], intr_out[:, 1, 1] = f[:, 0], f[:, 1]
    intr_out[:, 0, 2], intr_out[:, 1, 2] = W / 2.0, H / 2.0
    intr_out[:, 2, 2] = 1.0
    return torch.cat([R, t[..., None]], dim=-1), intr_out


def rank_by_dino_similarity(features, query_num: int) -> list:
    """Farthest-point sampling on frame-descriptor cosine similarity, on
    the host: features (S, D) -> `query_num` frame indices, frame 0
    first (utils/utils.py:265-308)."""
    f = (features.detach().float().cpu().numpy()
         if torch.is_tensor(features) else np.asarray(features, np.float32))
    f = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-12)
    sim = f @ f.T
    S = sim.shape[0]
    # the most "central" frame first (the reference ranks by total
    # similarity)
    order = np.argsort(-sim.sum(axis=1), kind="stable")
    selected = [int(order[0])]
    dist = 1.0 - sim
    for _ in range(min(query_num, S) - 1):
        d_min = dist[:, selected].min(axis=1)
        d_min[selected] = -1
        selected.append(int(d_min.argmax()))
    if 0 not in selected:
        selected[-1] = 0
    selected.sort(key=lambda i: i != 0)  # frame 0 first
    return selected


def rank_by_midpoint(S: int, query_num: int) -> list:
    """Evenly spread frames, frame 0 first (utils/utils.py:234-262)."""
    idx = np.linspace(0, S - 1, min(query_num, S)).round().astype(int)
    out = sorted(set(int(i) for i in idx))
    out.sort(key=lambda i: i != 0)
    return out


def rank_by_interval(S: int, k: int) -> list:
    """Stride ordering 0, k, 2k, ..., 1, k + 1, ... (utils/utils.py:253-262);
    the reference calls it with k = S // query_num + 1."""
    out = []
    for start in range(k):
        out.extend(range(start, S, k))
    return out
