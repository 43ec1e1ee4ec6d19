"""The port's query-point extractors against the JAX package's, on the same
inputs (made from a seed with numpy) and the same weights (JAX params
carried over by the `*_state_dict_from_jax` converters).

Tolerances (CPU): the CNNs in f32 1e-4 on O(1) outputs (conv sums in
another order); in bf16 the two frameworks round at the same places but
sum in other orders, so intermediates land on neighbouring bf16 values:
3e-2 on the sigmoid / softmax outputs, about the distance of either from
its own f32 result. Blur, Harris response and the DoG stack 1e-5 (short
f32 sums). Peak selection compares scores strictly, so on the same score
map the keypoints are equal entry by entry, ties included; from the same
image, where the maps differ by f32 rounding and a near-tie may flip, the
valid keypoints are held by overlap (>= 95%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggsfm_tpu.extractors import aliked as jal
from vggsfm_tpu.extractors import cnn as jcnn
from vggsfm_tpu.extractors import corners as jco
from vggsfm_tpu.extractors import dispatch as jdi
from vggsfm_tpu.extractors import dog as jdog
from vggsfm_tpu.extractors import superpoint as jsp
from vggsfm_tpu_torch.extractors import aliked as tal
from vggsfm_tpu_torch.extractors import cnn as tcnn
from vggsfm_tpu_torch.extractors import corners as tco
from vggsfm_tpu_torch.extractors import dispatch as tdi
from vggsfm_tpu_torch.extractors import dog as tdog
from vggsfm_tpu_torch.extractors import superpoint as tsp
from vggsfm_tpu_torch.models import convert as cv


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, atol):
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=0)


def _texture(seed, h, w):
    """A smooth RGB texture in [0, 1] with ~8 px blobs: corners and
    scale-space extrema for every detector."""
    rng = np.random.default_rng(seed)
    cells = rng.uniform(size=(h // 8 + 3, w // 8 + 3, 3)).astype(np.float32)
    big = np.asarray(jax.image.resize(cells, (h + 16, w + 16, 3), "cubic"))
    return np.clip(big[8:8 + h, 8:8 + w], 0, 1)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def aliked_params():
    """JAX ALIKED params with non-trivial folded BatchNorms."""
    rng = np.random.default_rng(3)
    p = jax.tree.map(np.asarray, jax.jit(jal.ALIKED().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    for k in range(1, 5):
        for bn in ("bn1", "bn2"):
            q = p["params"][f"block{k}"][bn]
            q["scale"] = rng.uniform(0.5, 1.5, q["scale"].shape).astype(
                np.float32)
            q["bias"] = (rng.normal(size=q["bias"].shape) * 0.1).astype(
                np.float32)
    return p


@pytest.fixture(scope="module")
def sddh_params():
    p = jax.tree.map(np.asarray, jax.jit(jal.SDDH().init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 128)),
        jnp.zeros((1, 4, 2))))
    for name in ("offset_conv1", "offset_conv2"):  # offsets of a few px
        p["params"][name]["kernel"] = p["params"][name]["kernel"] * 3.0
    return p


@pytest.fixture(scope="module")
def superpoint_params():
    return jax.tree.map(np.asarray, jax.jit(jsp.SuperPoint().init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 1))))


# ------------------------------------------------------------ weights

@pytest.mark.parametrize("which", ["aliked", "sddh", "superpoint"])
def test_state_dicts_round_trip_through_the_jax_converters(
        which, aliked_params, sddh_params, superpoint_params):
    """JAX params -> official key names -> the JAX package's own
    checkpoint converters give the params back (the BatchNorm's folded
    scale through running_var = 1 - eps: one f32 rounding), and the port's
    modules load them strictly."""
    params, to_sd, back, module = {
        "aliked": (aliked_params, cv.aliked_state_dict_from_jax,
                   jal.convert_aliked_checkpoint, tal.ALIKED()),
        "sddh": (sddh_params, cv.sddh_state_dict_from_jax,
                 jal.convert_sddh_checkpoint, tal.SDDH()),
        "superpoint": (superpoint_params, cv.superpoint_state_dict_from_jax,
                       jsp.convert_superpoint_checkpoint, tsp.SuperPoint()),
    }[which]
    sd = to_sd(params)
    want, got = _leaves(params), _leaves(back(sd))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    own = {k.removeprefix("desc_head."): v for k, v in sd.items()}
    assert set(own) == set(module.state_dict())
    module.load_state_dict(own)
    if which == "aliked":
        assert "block2.bn1.running_var" in sd and "score_head.6.bias" in sd


# --------------------------------------------------------------- CNNs

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_aliked_score_map_matches_jax(aliked_params, dtype):
    jdt, tdt, tol = ((jnp.float32, torch.float32, 1e-4) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, 3e-2))
    img = np.stack([_texture(0, 64, 96), _texture(1, 64, 96)])
    jscore, jfeats = jal.ALIKED(dtype=jdt).apply(
        aliked_params, jnp.asarray(img), return_feats=True)
    tm = tal.ALIKED(dtype=tdt).eval()
    tm.load_state_dict(cv.aliked_state_dict_from_jax(aliked_params))
    with torch.no_grad():
        score, feats = tm(_t(img), return_feats=True)
    assert score.dtype == torch.float32 and score.shape == (2, 64, 96)
    assert feats.shape == (2, 64, 96, 128) and feats.dtype == tdt
    _close(score, jscore.astype(jnp.float32), tol)
    if dtype == "f32":
        _close(feats, jfeats, 1e-4)


def test_sddh_descriptors_match_jax(rng, sddh_params):
    fmap = rng.normal(size=(2, 24, 30, 128)).astype(np.float32)
    kp = rng.uniform(-1, 31, size=(2, 9, 2)).astype(np.float32)
    kp[0, :3] = [[10.5, 12.5], [11.5, 3.5], [29.0, 23.0]]  # round half even
    jdesc, joff = jal.SDDH().apply(sddh_params, jnp.asarray(fmap),
                                   jnp.asarray(kp))
    tm = tal.SDDH().eval()
    tm.load_state_dict(cv.sddh_state_dict_from_jax(sddh_params, prefix=""))
    with torch.no_grad():
        desc, off = tm(_t(fmap), _t(kp))
    assert float(np.abs(np.asarray(joff)).max()) > 1.0  # offsets matter
    _close(off, joff, 1e-4)
    _close(desc, jdesc, 1e-4)
    _close(desc.norm(dim=-1), np.ones((2, 9)), 1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_superpoint_heat_map_matches_jax(superpoint_params, dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    gray = np.stack([_texture(2, 64, 80), _texture(3, 64, 80)])[..., :1]
    jheat, jdesc = jsp.SuperPoint(dtype=jdt).apply(superpoint_params,
                                                   jnp.asarray(gray))
    tm = tsp.SuperPoint(dtype=tdt).eval()
    tm.load_state_dict(cv.superpoint_state_dict_from_jax(superpoint_params))
    with torch.no_grad():
        heat, desc = tm(_t(gray))
    assert heat.shape == (2, 64, 80) and desc.shape == (2, 8, 10, 256)
    assert heat.dtype == desc.dtype == torch.float32
    # heat: a softmax over 65 bins, values ~1/65
    _close(heat, jheat, 1e-6 if dtype == "f32" else 3e-3)
    _close(desc, jdesc, 1e-4 if dtype == "f32" else 3e-2)


# ---------------------------------------------------- classical pieces

@pytest.mark.parametrize("sigma", [0.4, 1.5, 1.6, 5.08])
def test_gaussian_blur_matches_jax(sigma):
    """Radius int(3 sigma + 0.5) (at least 1), edge padding, rows then
    columns; a batch blurs as its images."""
    img = _texture(4, 40, 56)[..., 0]
    ref = jdog.gaussian_blur(jnp.asarray(img), sigma)
    _close(tdog.gaussian_blur(_t(img), sigma), ref, 1e-5)
    both = tdog.gaussian_blur(_t(np.stack([img, img[::-1]])), sigma)
    _close(both[0], ref, 1e-5)


def test_harris_response_and_dog_stack_match_jax():
    img = _texture(5, 48, 64)[..., 1]
    # the JAX functions inline these pieces: recompute them with jnp
    dx = 0.5 * (jnp.roll(img, -1, 1) - jnp.roll(img, 1, 1))
    dy = 0.5 * (jnp.roll(img, -1, 0) - jnp.roll(img, 1, 0))
    ixx, iyy, ixy = (jdog.gaussian_blur(a, 1.5)
                     for a in (dx * dx, dy * dy, dx * dy))
    jresp = ixx * iyy - ixy * ixy - 0.04 * (ixx + iyy) ** 2
    _close(tco.harris_response(_t(img)), jresp, 1e-5)
    k = 2.0 ** (1.0 / 3)
    jg = [jdog.gaussian_blur(jnp.asarray(img), 1.6 * k ** s)
          for s in range(6)]
    gauss, dogs = tdog.dog_stack(_t(img))
    assert dogs.shape == (5, 48, 64)
    for a, b in zip(gauss, jg):
        _close(a, b, 1e-5)
    _close(dogs, jnp.stack([jg[i + 1] - jg[i] for i in range(5)]), 1e-5)


def test_top_k_order_among_ties_is_jax_top_k():
    """Equal scores come lower index first, as jax.lax.top_k gives them:
    a quantized heat map with many exact ties, and the zeros of every
    rejected candidate."""
    rng = np.random.default_rng(6)
    heat = (rng.integers(0, 12, size=(40, 48)) / 16.0).astype(np.float32)
    jxy, jscore, jvalid = jsp.superpoint_keypoints_from_heatmap(
        jnp.asarray(heat), 300, nms_radius=1)
    xy, score, valid = tsp.superpoint_keypoints_from_heatmap(
        _t(heat), 300, nms_radius=1)
    assert 0 < int(valid.sum()) < 300  # valid peaks, then tied zeros
    np.testing.assert_array_equal(xy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    with pytest.raises(ValueError):
        tdog.top_k_stable(_t(heat).flatten(), 40 * 48 + 1)


@pytest.mark.parametrize("radius", [4, 2, 1])
def test_keypoints_from_the_same_heat_map_are_equal(rng, radius):
    border = 4
    heat = rng.uniform(size=(56, 72)).astype(np.float32)
    jxy, jscore, jvalid = jsp.superpoint_keypoints_from_heatmap(
        jnp.asarray(heat), 128, nms_radius=radius)
    xy, score, valid = tsp.superpoint_keypoints_from_heatmap(
        _t(heat), 128, nms_radius=radius)
    np.testing.assert_array_equal(xy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    v = xy[valid]
    assert bool(((v >= border) & (v[:, :1] < 72 - border)
                 & (v[:, 1:] < 56 - border)).all())


def _overlap(xy, valid, jxy, jvalid):
    a = {tuple(p) for p in xy.numpy()[valid.numpy()].tolist()}
    b = {tuple(p) for p in np.asarray(jxy)[np.asarray(jvalid)].tolist()}
    return len(a & b) / max(1, len(a | b)), len(a), len(b)


@pytest.mark.parametrize("which", ["dog", "harris"])
def test_classical_detectors_match_jax(which):
    img = _texture(7, 96, 128)[..., 0]
    jfn, tfn = {"dog": (jdog.detect_dog_keypoints,
                        tdog.detect_dog_keypoints),
                "harris": (jco.detect_harris_keypoints,
                           tco.detect_harris_keypoints)}[which]
    jxy, jscore, jvalid = jfn(jnp.asarray(img), 256)
    xy, score, valid = tfn(_t(img), 256)
    frac, n, jn = _overlap(xy, valid, jxy, jvalid)
    assert jn >= 20 and frac >= 0.95, (frac, n, jn)
    _close(score[:10], np.asarray(jscore)[:10], 1e-5)
    # a batch detects as its images
    bxy, _, bvalid = tfn(_t(np.stack([img, img.T.copy().T])), 256)
    np.testing.assert_array_equal(bxy[1].numpy(), xy.numpy())
    np.testing.assert_array_equal(bvalid[0].numpy(), valid.numpy())


# ------------------------------------------------------------ dispatch

@pytest.fixture
def f32_cnns(monkeypatch, aliked_params, superpoint_params):
    """Both packages' cached detector CNNs with the same weights, computing
    in f32, so that their peaks compare (in bf16 the two frameworks' score
    maps differ by more than neighbouring peaks do)."""
    monkeypatch.setitem(jcnn._CACHE, "aliked_params", aliked_params)
    monkeypatch.setitem(jcnn._CACHE, "superpoint_params", superpoint_params)
    monkeypatch.setitem(jcnn._CACHE, "aliked_apply", jax.jit(
        lambda p, im: jal.ALIKED().apply(p, im)))
    monkeypatch.setitem(jcnn._CACHE, "superpoint_apply", jax.jit(
        lambda p, im: jsp.SuperPoint().apply(p, im)))
    ta = tal.ALIKED().eval()
    ta.load_state_dict(cv.aliked_state_dict_from_jax(aliked_params))
    ts = tsp.SuperPoint().eval()
    ts.load_state_dict(cv.superpoint_state_dict_from_jax(superpoint_params))
    monkeypatch.setitem(tcnn._CACHE, ("aliked_torch.bfloat16", "cpu"), ta)
    monkeypatch.setitem(tcnn._CACHE, ("superpoint_torch.bfloat16", "cpu"), ts)


@pytest.mark.parametrize("method,masked", [
    ("sift", False), ("harris", True), ("aliked", False), ("sp", True),
    ("grid", True), ("sift+harris", True), ("sift+harris", False)])
def test_get_query_points_matches_jax(f32_cnns, method, masked):
    """The JAX-drawn permutation goes into the port's selection; with
    `masked`, a segmentation mask and a bounding box invalidate points."""
    H, W, K = 96, 128, 80
    img = _texture(8, H, W)
    key = jax.random.PRNGKey(5)
    seg = bbox = None
    if masked:
        seg = np.zeros((H, W), bool)
        seg[:, :40] = True
        bbox = (10.0, 12.0, 118.0, 80.0)
    jxy, jvalid = jdi.get_query_points(
        jnp.asarray(img), key, method, K,
        seg_invalid_mask=None if seg is None else jnp.asarray(seg),
        bound_bbox=bbox)
    n_cand = {"grid": int(K ** 0.5) ** 2}.get(
        method, K * len(method.split("+")))
    perm = _t(np.asarray(jax.random.permutation(key, n_cand)))
    xy, valid = tdi.get_query_points(
        _t(img), None, method, K,
        seg_invalid_mask=None if seg is None else _t(seg), bound_bbox=bbox,
        perm=perm)
    assert xy.shape == tuple(jxy.shape) and valid.shape == tuple(jvalid.shape)
    # (the grid's linspace rounds differently in the two frameworks)
    same = ((np.abs(xy.numpy() - np.asarray(jxy)) < 1e-4).all(-1)
            & (valid.numpy() == np.asarray(jvalid)))
    assert same.mean() >= 0.95, same.mean()
    assert int(valid.sum()) >= 10
    # valid first; masked points never valid
    v = valid.numpy()
    assert not v[int(v.sum()):].any()
    if masked:
        p = xy.numpy()[v]
        assert (p[:, 0] >= 40).all() and (p[:, 0] < 118).all()
        assert (p[:, 1] >= 12).all() and (p[:, 1] < 80).all()


def test_grid_and_auto_method(monkeypatch):
    np.testing.assert_allclose(
        tdi.grid_keypoints(60, 90, 30).numpy(),
        np.asarray(jdi.grid_keypoints(60, 90, 30)), atol=1e-5)
    monkeypatch.delenv("VGGSFM_TPU_ALIKED_CKPT", raising=False)
    assert tdi.resolve_query_method("auto") == "sift+harris"
    assert tdi.resolve_query_method("sp") == "sp"
    monkeypatch.setenv("VGGSFM_TPU_ALIKED_CKPT", "/some/aliked.pth")
    assert tdi.resolve_query_method("auto") == "aliked"
    with pytest.raises(ValueError, match="unknown query method"):
        tdi.get_query_points(torch.zeros(32, 32, 3), None, "orb", 8)


def test_batched_query_points_are_the_per_frame_ones():
    """One batched pass over the query frames gives each frame the points
    its own call would, with the permutations drawn in frame order."""
    imgs = _t(np.stack([_texture(9, 64, 64), _texture(10, 64, 64)]))
    gen = torch.Generator().manual_seed(4)
    bxy, bvalid = tdi.get_query_points_batched(imgs, gen, "sift+harris", 48)
    gen = torch.Generator().manual_seed(4)
    for q in range(2):
        xy, valid = tdi.get_query_points(imgs[q], gen, "sift+harris", 48)
        np.testing.assert_array_equal(bxy[q].numpy(), xy.numpy())
        np.testing.assert_array_equal(bvalid[q].numpy(), valid.numpy())


def test_seeded_cnn_detectors_and_descriptors():
    """Without checkpoints the cached models are seeded: the same points
    every time, descriptors of unit norm."""
    img = _t(_texture(11, 64, 64))
    xy, score, valid = tcnn.detect_aliked_keypoints(img, 32)
    xy2, _, _ = tcnn.detect_aliked_keypoints(img[None], 32)
    np.testing.assert_array_equal(xy2[0].numpy(), xy.numpy())
    assert int(valid.sum()) >= 8 and score.dtype == torch.float32
    sxy, _, svalid = tcnn.detect_superpoint_keypoints(img[..., 0], 32)
    assert sxy.shape == (32, 2) and int(svalid.sum()) >= 8
    desc = tcnn.describe_aliked_keypoints(img, xy)
    assert desc.shape == (32, 128)
    _close(desc.norm(dim=-1), np.ones(32), 1e-4)
    fresh = tcnn.init_extractor_(tal.ALIKED(),
                                 torch.Generator().manual_seed(0))
    cached = tcnn.load_aliked("cpu").state_dict()
    assert all(torch.equal(v, cached[k])
               for k, v in fresh.state_dict().items())


# -------------------------------------------------------------- runner

def _fake_predict_tracks(S, log, new_visible):
    """Stands in for predict_tracks on either runner: logs what was asked
    for and returns, per query frame, `max_query_pts` tracks of which
    `new_visible[round]` are visible in every frame."""

    def fake(images, fmaps, query_list, masks=None, query_method=None,
             max_query_pts=None, **_):
        n = max_query_pts * len(query_list)
        seen = new_visible[min(len(log), len(new_visible) - 1)]
        log.append((list(query_list), query_method, max_query_pts))
        vis = np.zeros((1, S, n), np.float32)
        vis[:, :, :seen] = 1.0
        return (np.zeros((1, S, n, 2), np.float32), vis,
                np.ones((1, S, n), np.float32))

    return fake


@pytest.mark.parametrize("new_visible,rounds", [((3,), 1), ((1, 1), 3),
                                                ((0, 0, 40), 2)])
def test_comple_nonvis_follows_the_jax_runner(monkeypatch, new_visible,
                                              rounds):
    """Frames 1 and 3 start under min_vis_points. Same rounds, same query
    lists, methods and point budgets as the JAX runner: re-query the first
    short frame; when it stays short, one last round over every short frame
    with 'sp+sift+aliked' at half the budget."""
    from vggsfm_tpu import runner as jrun
    from vggsfm_tpu_torch import runner as trun

    S, P = 4, 12
    vis0 = np.ones((1, S, P), np.float32)
    vis0[0, 1, 7:] = 0.0   # 7 visible: short of 8 by one
    vis0[0, 3, 5:] = 0.01  # below the 0.05 visibility threshold
    track0 = np.zeros((1, S, P, 2), np.float32)
    score0 = np.ones((1, S, P), np.float32)
    kw = dict(query_method="harris", max_query_pts=20, min_vis_points=8)

    jr = jrun.VGGSfMRunner(jrun.RunnerConfig(**kw))
    jlog = []
    jfake = _fake_predict_tracks(S, jlog, new_visible)
    monkeypatch.setattr(jr, "predict_tracks", lambda *a, **k: tuple(
        jnp.asarray(x) for x in jfake(*a, **k)))
    jt, jv, js = jr._comple_nonvis(None, None, jnp.asarray(track0),
                                   jnp.asarray(vis0), jnp.asarray(score0),
                                   None)

    tr = trun.VGGSfMRunner(trun.RunnerConfig(**kw), device="cpu")
    tlog = []
    tfake = _fake_predict_tracks(S, tlog, new_visible)
    monkeypatch.setattr(tr, "predict_tracks", lambda *a, **k: tuple(
        _t(x) for x in tfake(*a, **k)))
    tt, tv, ts = tr._comple_nonvis(None, None, _t(track0), _t(vis0),
                                   _t(score0), None)

    assert tlog == jlog and len(tlog) == rounds
    assert tlog[0] == ([1], "harris", 20)
    assert tlog[-1] == {(3,): ([1], "harris", 20),
                        (1, 1): ([3], "sp+sift+aliked", 10),
                        (0, 0, 40): ([1, 3], "sp+sift+aliked", 10)}[
                            new_visible]
    assert tt.shape == tuple(jt.shape) and ts.shape == tuple(js.shape)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_runner_extracts_its_own_query_points():
    """predict_tracks without caller-given points: one batched extraction
    over the query frames, the kernel route's few-track coarse calls (24
    points per call), masks honoured, the stage timed."""
    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner

    S, size, K = 3, 96, 24
    images = _t(np.stack([_texture(20 + s, size, size)
                          for s in range(S)]))[None]
    runner = VGGSfMRunner(RunnerConfig(
        precision="f32", query_method="sift+harris", max_query_pts=K,
        fine_tracking=False, coarse_iters=1), device="cpu")
    cfg = RunnerConfig()
    assert (cfg.query_method, cfg.max_query_pts, cfg.comple_nonvis,
            cfg.min_vis_points) == ("auto", 4096, True, 500)
    fmaps = runner.fmaps(images)
    tracks, vis, score = runner.predict_tracks(images, fmaps, [0, 2])
    assert tracks.shape == (1, S, 2 * K, 2) and vis.shape == (1, S, 2 * K)
    assert bool(torch.isfinite(tracks).all())
    assert runner.timings["query_points"] > 0
    qps, valids = runner.query_points(images, [0, 2])
    for q, frame in enumerate((0, 2)):  # query frames stay pinned
        assert torch.equal(tracks[0, frame, q * K:(q + 1) * K], qps[q])
        assert not vis[0, :, q * K:(q + 1) * K][:, ~valids[q]].any()
    # caller-given points still go through
    t2, _, _ = runner.predict_tracks(images, fmaps, [0, 2],
                                     query_points=qps, query_valid=valids)
    assert torch.equal(t2, tracks)
    masks = np.zeros((S, size, size), np.float32)
    masks[:, :, :48] = 1.0
    mqp, mvalid = runner.query_points(images, [2], masks=masks)
    assert int(mvalid[0].sum()) >= 4
    assert bool((mqp[0][mvalid[0]][:, 0] >= 48).all())


@pytest.mark.parametrize("comple_nonvis", [True, False])
def test_track_frames_reads_the_comple_nonvis_flag(comple_nonvis):
    """The tracking stage, real on the CPU at a small size: with the flag
    every frame is short of min_vis_points, so frame 0 is re-queried and,
    still short, every frame once more with 'sp+sift+aliked' at half the
    budget; without it the stage is predict_tracks."""
    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner

    S, size, K = 3, 96, 8
    images = _t(np.stack([_texture(30 + s, size, size)
                          for s in range(S)]))[None]
    runner = VGGSfMRunner(RunnerConfig(
        precision="f32", query_method="harris", max_query_pts=K,
        fine_tracking=False, coarse_iters=1, comple_nonvis=comple_nonvis,
        min_vis_points=10 * K), device="cpu")
    fmaps = runner.fmaps(images)
    tracks, vis, score = runner.track_frames(images, fmaps, [0, 1])
    P = 2 * K + (K + S * (K // 2) if comple_nonvis else 0)
    assert tracks.shape == (1, S, P, 2)
    assert vis.shape == score.shape == (1, S, P)
    assert bool(torch.isfinite(tracks).all())
    first, _, _ = runner.predict_tracks(images, fmaps, [0, 1])
    assert torch.equal(tracks[:, :, :2 * K], first)
