"""The weights-free query points ('sift+harris'), plain: each method's
candidates on one grayscale frame, strongest first, as the port's
extractors define them (a SIFT-style difference-of-Gaussians detector and
a Harris corner detector, each with a top-K). Written here from that
definition with convolutions where the port multiplies by blur matrices;
shifted comparisons wrap at the image edge, as the port's do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gray(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) -> (H, W), ITU-R 601 luma."""
    return (0.299 * image[..., 0] + 0.587 * image[..., 1]
            + 0.114 * image[..., 2])


def blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W) image: radius
    int(3 sigma + 0.5) (at least 1), edge pixels repeated."""
    r = max(1, int(3.0 * sigma + 0.5))
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    out = F.pad(img[None, None], (0, 0, r, r), mode="replicate")
    out = F.conv2d(out, k.view(1, 1, -1, 1))
    out = F.pad(out, (r, r, 0, 0), mode="replicate")
    return F.conv2d(out, k.view(1, 1, 1, -1))[0, 0]


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(x, (dy, dx), (-2, -1))


def _inner(h: int, w: int, border: int, device) -> torch.Tensor:
    m = torch.zeros(h, w, dtype=torch.bool, device=device)
    m[border:h - border, border:w - border] = True
    return m


def _top(score: torch.Tensor, xy: torch.Tensor, k: int):
    """The k strongest of flat `score` (ties: the lower index first);
    the candidates with a score above 0."""
    val, idx = torch.sort(score, descending=True, stable=True)
    val, idx = val[:k], idx[:k]
    return xy[idx], val > 0


def dog_candidates(img: torch.Tensor, k: int, octaves: int = 4,
                   per_octave: int = 3, contrast: float = 0.015,
                   edge_ratio: float = 10.0):
    """Scale-space extrema of the difference of Gaussians (sigma 1.6 x
    2^(s / per_octave)): a strict extremum among its 26 neighbours, |DoG|
    above `contrast`, the edge test of the DoG's Hessian, 4 px from the
    border; each octave from every second pixel of the previous one's
    level `per_octave`. (xy (k, 2), valid (k,))."""
    scores, coords = [], []
    mult = 1.0
    for _ in range(octaves):
        h, w = img.shape
        if min(h, w) < 16:
            break
        levels = [blur(img, 1.6 * 2.0 ** (s / per_octave))
                  for s in range(per_octave + 3)]
        dogs = torch.stack([b - a for a, b in zip(levels, levels[1:])])
        mid = dogs[1:-1]
        hi = torch.ones_like(mid, dtype=torch.bool)
        lo = torch.ones_like(mid, dtype=torch.bool)
        for ds in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if ds or dy or dx:
                        n = torch.roll(dogs, (ds, dy, dx), (0, 1, 2))[1:-1]
                        hi &= mid > n
                        lo &= mid < n
        keep = (hi | lo) & (mid.abs() > contrast)
        dxx = _shift(mid, 0, -1) + _shift(mid, 0, 1) - 2 * mid
        dyy = _shift(mid, -1, 0) + _shift(mid, 1, 0) - 2 * mid
        dxy = 0.25 * (_shift(mid, -1, -1) + _shift(mid, 1, 1)
                      - _shift(mid, -1, 1) - _shift(mid, 1, -1))
        tr, det = dxx + dyy, dxx * dyy - dxy * dxy
        keep &= (det > 0) & (tr * tr * edge_ratio
                             < (edge_ratio + 1) ** 2 * det)
        keep &= _inner(h, w, 4, img.device)
        scores.append(torch.where(keep, mid.abs(), 0.0).flatten())
        yy, xx = torch.meshgrid(torch.arange(h, device=img.device),
                                torch.arange(w, device=img.device),
                                indexing="ij")
        xy = torch.stack([xx, yy], -1).float().reshape(-1, 2) * mult
        coords.append(xy.repeat(per_octave, 1))
        img = levels[per_octave][::2, ::2]
        mult *= 2.0
    return _top(torch.cat(scores), torch.cat(coords), k)


def harris_candidates(img: torch.Tensor, k: int, kappa: float = 0.04,
                      radius: int = 4):
    """Harris response det - kappa tr^2 of the structure tensor (central
    differences, blurred with sigma 1.5), a strict maximum of its
    (2 radius + 1)^2 neighbourhood and above 0, 4 px from the border.
    (xy (k, 2), valid (k,))."""
    h, w = img.shape
    gx = 0.5 * (_shift(img, 0, -1) - _shift(img, 0, 1))
    gy = 0.5 * (_shift(img, -1, 0) - _shift(img, 1, 0))
    a, b, c = blur(gx * gx, 1.5), blur(gy * gy, 1.5), blur(gx * gy, 1.5)
    resp = a * b - c * c - kappa * (a + b) ** 2
    peak = resp > 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy or dx:
                peak &= resp > _shift(resp, dy, dx)
    peak &= _inner(h, w, 4, img.device)
    yy, xx = torch.meshgrid(torch.arange(h, device=img.device),
                            torch.arange(w, device=img.device),
                            indexing="ij")
    xy = torch.stack([xx, yy], -1).float().reshape(-1, 2)
    return _top(torch.where(peak, resp, 0.0).flatten(), xy, k)


METHODS = {"sift": dog_candidates, "harris": harris_candidates}


def candidates(image: torch.Tensor, method: str, k: int):
    """Every method's candidates ('sift+harris': both, k each) on one
    (H, W, 3) frame in [0, 1]: the valid points, (M, 2)."""
    g = gray(image.float())
    out = []
    for m in method.split("+"):
        xy, valid = METHODS[m](g, k)
        out.append(xy[valid])
    return torch.cat(out)
