"""COLMAP sparse-model data structures and binary/text readers and writers
(host-side, numpy). Counterpart of vggsfm_tpu/io/colmap.py, numpy path
only; the files are byte-identical to that package's.

The public COLMAP model format:
  cameras.bin:  u64 count; per camera: i32 id, i32 model_id, u64 w, u64 h,
                f64 params[num_params(model)]
  images.bin:   u64 count; per image: i32 id, f64 qvec[4] (w,x,y,z),
                f64 tvec[3], i32 camera_id, name\\0, u64 n_pts2d,
                (f64 x, f64 y, i64 point3D_id)*
  points3D.bin: u64 count; per point: u64 id, f64 xyz[3], u8 rgb[3],
                f64 error, u64 track_len, (i32 image_id, i32 p2d_idx)*
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

# model_id -> (name, num_params). Params layouts follow COLMAP:
#   SIMPLE_PINHOLE: f, cx, cy
#   PINHOLE:        fx, fy, cx, cy
#   SIMPLE_RADIAL:  f, cx, cy, k
#   RADIAL:         f, cx, cy, k1, k2
#   OPENCV:         fx, fy, cx, cy, k1, k2, p1, p2
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
CAMERA_MODEL_NUM_PARAMS = {name: n for _, (name, n) in CAMERA_MODELS.items()}

_OBS = np.dtype([("x", "<f8"), ("y", "<f8"), ("pid", "<i8")])
_TRACK = np.dtype([("im", "<i4"), ("idx", "<i4")])
# a points3D.bin record before its track: id, xyz, rgb, error, track_len
_POINT = np.dtype([("id", "<u8"), ("xyz", "<f8", (3,)), ("rgb", "u1", (3,)),
                   ("error", "<f8"), ("len", "<u8")])


@dataclasses.dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # (num_params,) float64


@dataclasses.dataclass
class Image:
    id: int
    qvec: np.ndarray  # (4,) w,x,y,z — world->cam rotation
    tvec: np.ndarray  # (3,) world->cam translation
    camera_id: int
    name: str
    xys: np.ndarray  # (M, 2)
    point3D_ids: np.ndarray  # (M,) int64, -1 if unmatched


@dataclasses.dataclass
class Point3D:
    id: int
    xyz: np.ndarray  # (3,)
    rgb: np.ndarray  # (3,) uint8
    error: float
    image_ids: np.ndarray  # (L,) int32
    point2D_idxs: np.ndarray  # (L,) int32


@dataclasses.dataclass
class Reconstruction:
    cameras: dict  # id -> Camera
    images: dict  # id -> Image
    points3D: dict  # id -> Point3D


# ---------------------------------------------------------------------------
# binary writers
# ---------------------------------------------------------------------------


def write_cameras_binary(cameras: dict, path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id = CAMERA_MODEL_IDS[cam.model]
            n = CAMERA_MODELS[model_id][1]
            params = np.asarray(cam.params, np.float64)
            assert params.shape == (n,), (cam.model, params.shape)
            f.write(struct.pack("<iiQQ", cam.id, model_id,
                                int(cam.width), int(cam.height)))
            f.write(params.tobytes())


def write_images_binary(images: dict, path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(np.asarray(im.qvec, np.float64).tobytes())
            f.write(np.asarray(im.tvec, np.float64).tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            m = len(im.xys)
            f.write(struct.pack("<Q", m))
            rec = np.empty((m,), _OBS)
            if m:
                xys = np.asarray(im.xys)
                rec["x"], rec["y"] = xys[:, 0], xys[:, 1]
                rec["pid"] = np.asarray(im.point3D_ids, np.int64)
            f.write(rec.tobytes())


def write_points3D_binary(points3D: dict, path: str) -> None:
    """All records packed at once: the fixed part of every point and the
    tracks are scattered into one byte buffer by their offsets."""
    pts = list(points3D.values())
    n = len(pts)
    head = np.empty((n,), _POINT)
    lens = np.fromiter((len(p.image_ids) for p in pts), np.int64, n)
    if n:
        head["id"] = [p.id for p in pts]
        head["xyz"] = np.asarray([p.xyz for p in pts], np.float64)
        head["rgb"] = np.asarray([p.rgb for p in pts], np.uint8)
        head["error"] = [float(p.error) for p in pts]
        head["len"] = lens
    track = np.empty((int(lens.sum()),), _TRACK)
    if len(track):
        track["im"] = np.concatenate([np.asarray(p.image_ids, np.int32)
                                      for p in pts])
        track["idx"] = np.concatenate([np.asarray(p.point2D_idxs, np.int32)
                                       for p in pts])
    hsize, tsize = _POINT.itemsize, _TRACK.itemsize
    rec_bytes = hsize + tsize * lens
    starts = np.cumsum(rec_bytes) - rec_bytes
    buf = np.empty((int(rec_bytes.sum()),), np.uint8)
    buf[(starts[:, None] + np.arange(hsize)).reshape(-1)] = \
        head.view(np.uint8)
    tbytes = tsize * lens
    tstarts = np.cumsum(tbytes) - tbytes
    buf[np.repeat(starts + hsize - tstarts, tbytes)
        + np.arange(int(tbytes.sum()))] = track.view(np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        f.write(buf.tobytes())


# ---------------------------------------------------------------------------
# binary readers
# ---------------------------------------------------------------------------


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> dict:
    cameras = {}
    with open(path, "rb") as f:
        (n_cams,) = _read(f, "<Q")
        for _ in range(n_cams):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.frombuffer(f.read(8 * n_params), "<f8").copy()
            cameras[cam_id] = Camera(cam_id, name, w, h, params)
    return cameras


def read_images_binary(path: str) -> dict:
    images = {}
    with open(path, "rb") as f:
        (n_images,) = _read(f, "<Q")
        for _ in range(n_images):
            (im_id,) = _read(f, "<i")
            qvec = np.frombuffer(f.read(32), "<f8").copy()
            tvec = np.frombuffer(f.read(24), "<f8").copy()
            (cam_id,) = _read(f, "<i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (m,) = _read(f, "<Q")
            rec = np.frombuffer(f.read(24 * m), _OBS)
            xys = np.stack([rec["x"], rec["y"]], axis=-1) if m else \
                np.zeros((0, 2))
            images[im_id] = Image(im_id, qvec, tvec, cam_id,
                                  name.decode("utf-8"), xys,
                                  rec["pid"].copy())
    return images


def read_points3D_binary(path: str) -> dict:
    points = {}
    with open(path, "rb") as f:
        (n_pts,) = _read(f, "<Q")
        for _ in range(n_pts):
            (pid,) = _read(f, "<Q")
            xyz = np.frombuffer(f.read(24), "<f8").copy()
            rgb = np.frombuffer(f.read(3), np.uint8).copy()
            (error,) = _read(f, "<d")
            (ln,) = _read(f, "<Q")
            rec = np.frombuffer(f.read(8 * ln), _TRACK)
            points[pid] = Point3D(pid, xyz, rgb, error,
                                  rec["im"].copy(), rec["idx"].copy())
    return points


# ---------------------------------------------------------------------------
# text writers (debug-friendly; same content as binary)
# ---------------------------------------------------------------------------


def write_cameras_text(cameras: dict, path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} "
                    f"{params}\n")


def write_images_text(images: dict, path: str) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            q = " ".join(repr(float(x)) for x in im.qvec)
            t = " ".join(repr(float(x)) for x in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            obs = " ".join(
                f"{x} {y} {pid}"
                for (x, y), pid in zip(im.xys, im.point3D_ids))
            f.write(obs + "\n")


def write_points3D_text(points3D: dict, path: str) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pt in points3D.values():
            xyz = " ".join(repr(float(x)) for x in pt.xyz)
            rgb = " ".join(str(int(x)) for x in pt.rgb)
            track = " ".join(f"{im} {idx}" for im, idx in
                             zip(pt.image_ids, pt.point2D_idxs))
            f.write(f"{pt.id} {xyz} {rgb} {pt.error} {track}\n")


def write_model(rec: Reconstruction, path: str, ext: str = ".bin") -> None:
    """Write cameras/images/points3D to `path` (created if needed)."""
    os.makedirs(path, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(rec.cameras, os.path.join(path, "cameras.bin"))
        write_images_binary(rec.images, os.path.join(path, "images.bin"))
        write_points3D_binary(rec.points3D,
                              os.path.join(path, "points3D.bin"))
    elif ext == ".txt":
        write_cameras_text(rec.cameras, os.path.join(path, "cameras.txt"))
        write_images_text(rec.images, os.path.join(path, "images.txt"))
        write_points3D_text(rec.points3D, os.path.join(path, "points3D.txt"))
    else:
        raise ValueError(ext)


def read_model(path: str) -> Reconstruction:
    return Reconstruction(
        cameras=read_cameras_binary(os.path.join(path, "cameras.bin")),
        images=read_images_binary(os.path.join(path, "images.bin")),
        points3D=read_points3D_binary(os.path.join(path, "points3D.bin")),
    )
