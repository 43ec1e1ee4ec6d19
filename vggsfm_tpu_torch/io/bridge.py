"""Array batch <-> Reconstruction bridge (host-side, numpy). Counterpart
of vggsfm_tpu/io/bridge.py (reference vggsfm/utils/tensor_to_pycolmap.py:
16-214): the dense padded arrays and masks of the pipeline become ragged
COLMAP structures, masked lanes dropped. The arrays are numpy: the caller
copies its tensors to the host once.
"""

from __future__ import annotations

import numpy as np

from vggsfm_tpu_torch.io.colmap import (
    Camera,
    Image,
    Point3D,
    Reconstruction,
)


def _matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) rotation -> (w,x,y,z) quaternion (numpy, host-side)."""
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                      (m10 - m01) / s])
    elif m00 > m11 and m00 > m22:
        s = np.sqrt(1.0 + m00 - m11 - m22) * 2
        q = np.array([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                      (m02 + m20) / s])
    elif m11 > m22:
        s = np.sqrt(1.0 + m11 - m00 - m22) * 2
        q = np.array([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                      (m12 + m21) / s])
    else:
        s = np.sqrt(1.0 + m22 - m00 - m11) * 2
        q = np.array([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                      0.25 * s])
    return q / np.linalg.norm(q)


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _camera_params(camera_type: str, K: np.ndarray,
                   extra: np.ndarray | None) -> np.ndarray:
    f = float(K[0, 0])
    fx, fy = float(K[0, 0]), float(K[1, 1])
    cx, cy = float(K[0, 2]), float(K[1, 2])
    k = np.asarray(extra, np.float64) if extra is not None else \
        np.zeros((4,))
    if camera_type == "SIMPLE_PINHOLE":
        return np.array([f, cx, cy])
    if camera_type == "PINHOLE":
        return np.array([fx, fy, cx, cy])
    if camera_type == "SIMPLE_RADIAL":
        return np.array([f, cx, cy, k[0] if k.size else 0.0])
    if camera_type == "RADIAL":
        return np.array([f, cx, cy, k[0], k[1]])
    if camera_type == "OPENCV":
        return np.array([fx, fy, cx, cy, k[0], k[1], k[2], k[3]])
    raise ValueError(camera_type)


def _params_to_K_extra(model: str, params: np.ndarray):
    if model == "SIMPLE_PINHOLE":
        f, cx, cy = params
        return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]]), None
    if model == "PINHOLE":
        fx, fy, cx, cy = params
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]), None
    if model == "SIMPLE_RADIAL":
        f, cx, cy, k = params
        return (np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]]),
                np.array([k]))
    if model == "RADIAL":
        f, cx, cy, k1, k2 = params
        return (np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]]),
                np.array([k1, k2]))
    if model == "OPENCV":
        fx, fy, cx, cy, k1, k2, p1, p2 = params
        return (np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]),
                np.array([k1, k2, p1, p2]))
    raise ValueError(model)


def arrays_to_reconstruction(
    points3d: np.ndarray,
    extrinsics: np.ndarray,
    intrinsics: np.ndarray,
    tracks: np.ndarray,
    masks: np.ndarray,
    image_size,
    extra_params: np.ndarray | None = None,
    shared_camera: bool = False,
    camera_type: str = "SIMPLE_PINHOLE",
    image_names: list | None = None,
    colors: np.ndarray | None = None,
    reproj_errors: np.ndarray | None = None,
) -> Reconstruction:
    """Dense padded batch -> ragged Reconstruction.

    Args:
      points3d: (P, 3); extrinsics (S, 3, 4); intrinsics (S, 3, 3);
      tracks (S, P, 2); masks (S, P) bool; image_size (width, height).
      Point p observed in frame s iff masks[s, p].

    Image/camera ids are 1-based (COLMAP convention), point ids 0-based
    like the reference bridge (tensor_to_pycolmap.py:60-89). A point is
    kept when it is observed at least twice. The observations are
    gathered with array ops: a point's track lists its frames in order,
    each with the observation's index within its frame.
    """
    points3d = np.asarray(points3d, np.float64)
    extrinsics = np.asarray(extrinsics, np.float64)
    intrinsics = np.asarray(intrinsics, np.float64)
    tracks = np.asarray(tracks, np.float64)
    masks = np.asarray(masks, bool)
    S, P = masks.shape
    width, height = int(image_size[0]), int(image_size[1])

    # a point must be seen at least twice to be registered
    valid_pts = masks.sum(axis=0) >= 2
    obs = masks & valid_pts[None]
    # index of each observation within its frame's list
    obs_idx = np.cumsum(obs, axis=1) - 1

    cameras = {}
    images = {}
    for s in range(S):
        cam_id = 1 if shared_camera else s + 1
        if cam_id not in cameras:
            extra_s = (extra_params[s] if extra_params is not None else None)
            cameras[cam_id] = Camera(
                cam_id, camera_type, width, height,
                _camera_params(camera_type, intrinsics[s], extra_s))
        pids = np.nonzero(obs[s])[0]
        images[s + 1] = Image(
            id=s + 1,
            qvec=_matrix_to_quat(extrinsics[s, :, :3]),
            tvec=extrinsics[s, :, 3].copy(),
            camera_id=cam_id,
            name=(image_names[s] if image_names is not None
                  else f"image_{s:04d}.png"),
            xys=tracks[s, pids],
            point3D_ids=pids.astype(np.int64),
        )

    # every observation, point-major, frames ascending within a point
    ps, ss = np.nonzero(obs.T)
    pts = np.nonzero(valid_pts)[0]
    cuts = np.cumsum(obs.sum(axis=0)[pts])[:-1]
    im_ids = np.split((ss + 1).astype(np.int32), cuts)
    idxs = np.split(obs_idx[ss, ps].astype(np.int32), cuts)
    rgbs = (np.asarray(colors, np.uint8)[pts] if colors is not None
            else np.zeros((len(pts), 3), np.uint8))
    points3D = {}
    for i, p in enumerate(pts.tolist()):
        err = float(reproj_errors[p]) if reproj_errors is not None else 0.0
        points3D[p] = Point3D(p, points3d[p], rgbs[i], err, im_ids[i],
                              idxs[i])
    return Reconstruction(cameras, images, points3D)


def rescale_reconstruction_to_original(
    rec: Reconstruction,
    crop_params: np.ndarray,
    img_size: int,
    image_names: list | None = None,
    shift_point2d_to_original_res: bool = True,
    shared_camera: bool = False,
) -> Reconstruction:
    """Map a reconstruction from resized-square space back to original
    image coordinates, in place.

    Parity: runners/runner.py:1009-1052
    (`rename_colmap_recons_and_rescale_camera`): per image, focal scales by
    max(W, H)/img_size, the principal point becomes (W//2, H//2), the
    camera's width/height become the original size, and points2D shift by
    the (padded) crop offset then rescale. With `shared_camera` the single
    camera is rescaled once (using the first image's original size).

    Args:
      crop_params: (S, 8) rows [W, H, crop_width, s, bbox_after(4)] from
        `pad_and_resize_image` (bbox_after is at resized-square scale).
    """
    crop_params = np.asarray(crop_params, np.float64)
    rescale_camera = True
    for im_id in sorted(rec.images):
        # index metadata by image id, not enumeration position — the
        # model may have had invalid frames deregistered, leaving holes
        s = im_id - 1
        image = rec.images[im_id]
        camera = rec.cameras[image.camera_id]
        if image_names is not None:
            image.name = image_names[s]

        real_w, real_h = crop_params[s, 0], crop_params[s, 1]
        ratio = max(real_w, real_h) / float(img_size)

        if rescale_camera:
            params = np.asarray(camera.params, np.float64).copy()
            if camera.model in ("PINHOLE", "OPENCV"):
                params[0:2] *= ratio
                params[2:4] = [real_w // 2, real_h // 2]
            else:  # SIMPLE_* layouts: [f, cx, cy, ...]
                params[0] *= ratio
                params[1:3] = [real_w // 2, real_h // 2]
            camera.params = params
            camera.width = int(real_w)
            camera.height = int(real_h)
        if shared_camera:
            rescale_camera = False

        if shift_point2d_to_original_res and len(image.xys):
            top_left = np.abs(crop_params[s, 4:6])
            image.xys = (np.asarray(image.xys, np.float64)
                         - top_left) * ratio
    return rec


def reconstruction_to_arrays(rec: Reconstruction,
                             num_points: int | None = None):
    """Ragged Reconstruction -> dense arrays.

    Returns (points3d (P,3), extrinsics (S,3,4), intrinsics (S,3,3),
    extra_params (S,K)|None, point_mask (P,)) where P covers point ids
    0..max_id (or `num_points`); point_mask marks ids present in `rec`.
    Parity: tensor_to_pycolmap.py:163-214.
    """
    im_ids = sorted(rec.images)
    S = len(im_ids)
    extrinsics = np.zeros((S, 3, 4))
    intrinsics = np.zeros((S, 3, 3))
    extras = []
    for i, im_id in enumerate(im_ids):
        im = rec.images[im_id]
        extrinsics[i, :, :3] = _quat_to_matrix(im.qvec)
        extrinsics[i, :, 3] = im.tvec
        K, extra = _params_to_K_extra(rec.cameras[im.camera_id].model,
                                      rec.cameras[im.camera_id].params)
        intrinsics[i] = K
        extras.append(extra)
    extra_params = (np.stack(extras) if extras and extras[0] is not None
                    else None)

    if num_points is None:
        num_points = (max(rec.points3D) + 1) if rec.points3D else 0
    points3d = np.zeros((num_points, 3))
    mask = np.zeros((num_points,), bool)
    for pid, pt in rec.points3D.items():
        if pid < num_points:
            points3d[pid] = pt.xyz
            mask[pid] = True
    return points3d, extrinsics, intrinsics, extra_params, mask
