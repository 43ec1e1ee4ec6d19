"""The port's camera slice against the JAX package's, on the same numpy
inputs and the same weights (JAX params carried over by
`camera_state_dict_from_jax`).

* `fused_ln_attn_ref` against JAX's `fused_ln_attn` Pallas kernel in
  interpret mode. f32 within 5e-5 absolute (sums in another order, O(1-4)
  outputs); bf16 within 2 ulp of those outputs (0.0625): both sides round
  at the same points, but a different summation order may round q/k/v, a
  probability or a head output the other way, and that ulp passes through
  the out-projection.
* DINOv2, the camera predictor, the decode, the averaging and the ranking
  against their JAX modules, which run their plain jnp paths on the CPU;
  the port's wrappers take their plain versions there. f32 tolerances are
  stated per test (sums in another order through deep stacks). In bf16 the
  two sides round at different points by design (flax's Dense rounds the
  product and the bias add separately, jnp.gelu rounds inside its bf16
  arithmetic, and the JAX cross-attention tails take their plain path on
  the CPU where the port takes the fused kernel's f32-residual numerics),
  so bf16 is held by the dtype flow (each output has the JAX dtype, and
  the features are bf16 exactly where JAX's are) and by tolerances of the
  order of one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggsfm_tpu.geometry import cameras as jcam
from vggsfm_tpu.geometry import rotations as jrot
from vggsfm_tpu.models import layers as jlay
from vggsfm_tpu.models.camera import CameraPredictor as JCamera
from vggsfm_tpu.models.dinov2 import DinoVisionTransformer as JDino
from vggsfm_tpu.models.embeddings import harmonic_embedding as j_harm
from vggsfm_tpu.ops import fused_mlp as jfm
from vggsfm_tpu.utils import camera_avg as javg
from vggsfm_tpu_torch.geometry import cameras as tcam
from vggsfm_tpu_torch.geometry import rotations as trot
from vggsfm_tpu_torch.models import convert as cv
from vggsfm_tpu_torch.models import layers as tlay
from vggsfm_tpu_torch.models.camera import CameraPredictor
from vggsfm_tpu_torch.models.dinov2 import DinoVisionTransformer
from vggsfm_tpu_torch.models.embeddings import harmonic_embedding
from vggsfm_tpu_torch.ops import fused_mlp as tfm
from vggsfm_tpu_torch.utils import camera_avg as tavg

TINY = dict(hidden_size=64, num_heads=4, z_dim=768, down_size=28,
            att_depth=2, trunk_depth=2)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(out, ref, atol):
    np.testing.assert_allclose(
        out.detach().float().numpy(),
        np.asarray(jnp.asarray(ref, jnp.float32)), atol=atol, rtol=0)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _mk(rng, *shape, scale=0.05):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ------------------------------------------------------------ the kernel

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,tracks,C,H", [(8, 16, 128, 8), (9, 7, 128, 8),
                                          (8, 4, 192, 2)])
def test_ln_attn_plain_matches_pallas(rng, dtype, L, tracks, C, H):
    """L = 9 pads the Pallas grid; C = 192 with 2 heads is head dim 96."""
    x = _mk(rng, tracks * L, C) * 20
    wi, bi, wo, bo = _mk(rng, C, 3 * C), _mk(rng, 3 * C), _mk(rng, C, C), \
        _mk(rng, C)
    jdt = jnp.dtype(dtype)
    ref = jfm.fused_ln_attn(jnp.asarray(x, jdt), jnp.asarray(wi, jdt),
                            jnp.asarray(bi, jdt), jnp.asarray(wo, jdt),
                            jnp.asarray(bo, jdt), L, H, interpret=True)
    tdt = getattr(torch, dtype)
    out = tfm.fused_ln_attn_ref(
        _t(x).to(tdt), _t(wi.T).to(tdt), _t(bi).to(tdt), _t(wo.T).to(tdt),
        _t(bo).to(tdt), L, H)
    assert out.dtype == tdt
    _close(out, ref, 5e-5 if dtype == "float32" else 0.0625)


def test_kernel_gates_at_the_camera_shapes():
    """Per camera forward: the trunk's attention halves (f32, L = S = 8,
    C = 768, 8 heads of 96) take fused_ln_attn, the cross-attention tails
    (bf16, C = 768) fused_ln_mlp; the self-attention blocks (L = 577) and
    the f32 768-wide MLP tails stay plain; the whole-block kernel takes
    none of them. The tracker's shapes keep their kernels (the f32 tail at
    384 too; an f32 block runs as its halves)."""
    bf, f32 = torch.bfloat16, torch.float32
    assert tfm.ln_attn_takes(768, 8, 8)
    assert not tfm.block_route_takes(bf, 768, 8, 8, 3072)
    assert not tfm.block_route_takes(f32, 768, 8, 8, 3072)
    assert not tfm.ln_attn_takes(768, 577, 8)
    assert tfm.mlp_route_takes(bf, 768, 3072)
    assert not tfm.mlp_route_takes(f32, 768, 3072)
    assert tfm.block_route_takes(bf, 384, 8, 8, 1536)
    assert tfm.mlp_route_takes(bf, 384, 1536)
    assert not tfm.block_route_takes(f32, 384, 8, 8, 1536)
    assert tfm.mlp_route_takes(f32, 384, 1536)


def test_trunk_block_dtype_flow(rng, monkeypatch):
    """A 768-wide bf16 AttnBlock on f32 tokens (the camera trunk): JAX
    promotes the tokens against bf16-rounded weights and stays f32; the
    port does the same, its attention half through fused_ln_attn and its
    MLP half plain."""
    C, H, L = 768, 8, 8
    x = rng.normal(size=(2, L, C)).astype(np.float32) * 2
    jm = jlay.AttnBlock(C, H, dtype=jnp.bfloat16)
    p = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    tm = tlay.AttnBlock(C, H, dtype=torch.bfloat16)
    sd = {}
    cv._mha(sd, "attn", p["params"]["attn"])
    cv._mlp(sd, "mlp", p["params"]["mlp"])
    tm.load_state_dict(sd)
    calls = []
    real = tlay.fused_ln_attn

    def spy(*a, **k):
        calls.append(a[0].dtype)
        return real(*a, **k)

    monkeypatch.setattr(tlay, "fused_ln_attn", spy)
    monkeypatch.setattr(tlay, "fused_ln_mlp", None)  # must not be reached
    with torch.no_grad():
        out = tm(_t(x))
    ref = jax.jit(jm.apply)(p, x)
    assert calls == [torch.float32] and out.dtype == torch.float32
    assert ref.dtype == jnp.float32
    _close(out, ref, 1e-4)


# ------------------------------------------------------------- DINOv2

@pytest.fixture(scope="module")
def dino_pair():
    rng = np.random.default_rng(4)
    jm = JDino(embed_dim=32, depth=2, num_heads=4, patch_size=14,
               pos_embed_size=4)
    x = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
    p = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    # non-trivial tokens, norms and LayerScale gammas
    for name in ("cls_token", "register_tokens"):
        p["params"][name] = _mk(rng, *p["params"][name].shape, scale=0.5)
    for i in range(2):
        blk = p["params"][f"blocks_{i}"]
        for k in ("ls1_gamma", "ls2_gamma"):
            blk[k] = 1.0 + _mk(rng, 32, scale=0.3)
        blk["norm1"]["bias"] = _mk(rng, 32, scale=0.3)
    sd = {}
    cv._dinov2(sd, "m", p["params"])
    return jm, p, {k[2:]: v for k, v in sd.items()}, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dinov2(dino_pair, dtype):
    jm0, p, sd, x = dino_pair
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jm = JDino(embed_dim=32, depth=2, num_heads=4, patch_size=14,
               pos_embed_size=4, dtype=jdt)
    tm = DinoVisionTransformer(embed_dim=32, depth=2, num_heads=4,
                               pos_embed_size=4, dtype=tdt)
    tm.load_state_dict(sd)
    ref = jax.jit(jm.apply)(p, x)
    with torch.no_grad():
        out = tm(_t(x))
    assert out.shape == ref.shape == (2, 4, 32)
    assert out.dtype == tdt and ref.dtype == jdt
    # f32: two LayerNorm'd blocks of short sums; bf16: 4 ulp of the O(1-3)
    # normalized tokens, as the two sides round the products, biases and
    # GELU at different points
    _close(out, ref, 1e-4 if dtype == "float32" else 0.0625)


def test_harmonic_embedding(rng):
    x = rng.normal(size=(2, 3, 8)).astype(np.float32)
    for n, app in ((4, False), (48, False), (3, True)):
        _close(harmonic_embedding(_t(x), n, append_input=app),
               j_harm(jnp.asarray(x), n, append_input=app), 1e-4)


# ---------------------------------------------------------- the predictor

@pytest.fixture(scope="module")
def camera_pair():
    """A tiny JAX camera predictor's params (pose token and pose branch
    made non-trivial) and the port's state_dict of the same weights."""
    rng = np.random.default_rng(5)
    images = rng.uniform(size=(1, 3, 28, 28, 3)).astype(np.float32)
    p = _np(jax.jit(lambda k, i: JCamera(**TINY).init(k, i, iters=2))(
        jax.random.PRNGKey(0), images))
    p["params"]["pose_token"] = _mk(rng, 1, 1, 1, 64, scale=0.5)
    p["params"]["pose_branch"]["fc2"]["bias"] = _mk(rng, 72, scale=0.5)
    return p, cv.camera_state_dict_from_jax(p), images


def _port_camera(sd, dtype):
    tm = CameraPredictor(**TINY, dtype=dtype)
    tm.load_state_dict(sd)
    return tm.eval()


def _jax_run(p, images, dtype, method=None):
    jm = JCamera(**TINY, dtype=dtype)
    if method:
        return jax.jit(lambda pp, i: jm.apply(pp, i, method=method))(
            p, images)
    return jax.jit(lambda pp, i: jm.apply(pp, i, iters=2))(p, images)


@pytest.fixture(scope="module")
def camera_runs(camera_pair):
    """pose encodings, rgb_feat_init and frame descriptors of both sides
    in f32 and bf16."""
    p, sd, images = camera_pair
    out = {}
    for name in ("float32", "bfloat16"):
        jdt, tdt = jnp.dtype(name), getattr(torch, name)
        j = _jax_run(p, images, jdt)
        jd = _jax_run(p, images, jdt, "frame_descriptors")
        tm = _port_camera(sd, tdt)
        with torch.no_grad():
            t = tm(_t(images), iters=2)
            td = tm.frame_descriptors(_t(images))
        out[name] = (j, jd, t, td)
    return out


def test_camera_predictor_f32(camera_runs):
    j, jd, t, td = camera_runs["float32"]
    # f32 through a 12-block ViT-B and 2 x (self + cross) blocks, then two
    # trunk iterations, summed in other orders: 1e-4 on the O(1) features
    # and pose encodings
    _close(t["rgb_feat_init"], j["rgb_feat_init"], 1e-4)
    _close(t["pred_pose_enc"], j["pred_pose_enc"], 1e-4)
    _close(td, jd, 1e-4)
    assert np.abs(np.asarray(j["pred_pose_enc"])).max() > 0.1


def _bf16_exact(a) -> bool:
    a = np.asarray(a, np.float32)
    return bool(np.all(a == a.astype(jnp.bfloat16).astype(np.float32)))


def test_camera_predictor_bf16_dtype_flow(camera_runs):
    j, jd, t, td = camera_runs["bfloat16"]
    # the JAX dtypes: f32 features, pose encodings and descriptors
    for a, b in ((t["rgb_feat_init"], j["rgb_feat_init"]),
                 (t["pred_pose_enc"], j["pred_pose_enc"]), (td, jd)):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
    # frame 0's pose token leaves the last f32 self-attention block; the
    # other frames' leave a cross-attention block, which rounds to bf16
    for feat in (t["rgb_feat_init"].numpy(), np.asarray(j["rgb_feat_init"])):
        assert _bf16_exact(feat[:, 1:]) and not _bf16_exact(feat[:, 0])
    # one bf16 ulp (0.03125) of the largest, O(4-8), features; the pose
    # encodings (O(3), summed in f32 from them) and the descriptors (means
    # of bf16 tokens) within the same order
    _close(t["rgb_feat_init"], j["rgb_feat_init"], 0.03125)
    _close(t["pred_pose_enc"], j["pred_pose_enc"], 0.05)
    _close(td, jd, 0.0625)  # as the DINOv2 tokens they average


# ---------------------------------------------------------------- geometry

def test_quaternion_conversions(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[:4] = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, -1]]
    R = trot.quaternion_to_matrix(_t(q))
    _close(R, jrot.quaternion_to_matrix(jnp.asarray(q)), 1e-6)
    back = trot.matrix_to_quaternion(R)
    _close(back, jrot.matrix_to_quaternion(jnp.asarray(R.numpy())), 1e-6)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    # the round trip gives q or -q; standardized, q itself (w > 0 rows)
    pos = qn[:, 0] > 1e-3
    _close(trot.standardize_quaternion(back)[pos],
           jrot.standardize_quaternion(jnp.asarray(qn))[pos], 1e-5)
    _close(trot.standardize_quaternion(_t(qn)),
           jrot.standardize_quaternion(jnp.asarray(qn)), 0)


def test_se3_inverse_and_compose(rng):
    q = rng.normal(size=(2, 5, 4)).astype(np.float32)
    R = np.asarray(jrot.quaternion_to_matrix(jnp.asarray(q)))
    t = rng.normal(size=(2, 5, 3, 1)).astype(np.float32)
    E = np.concatenate([R, t], -1)
    E4 = np.concatenate([E, np.broadcast_to([[[[0, 0, 0, 1]]]],
                                            (2, 5, 1, 4))], -2)
    for a in (E, E4.astype(np.float32)):
        _close(tcam.se3_inverse(_t(a)), jcam.se3_inverse(jnp.asarray(a)),
               1e-6)
    _close(tcam.se3_compose(_t(E), _t(E[:, ::-1])),
           jcam.se3_compose(jnp.asarray(E), jnp.asarray(E[:, ::-1])), 1e-5)


def test_pose_encoding_decode_and_round_trip(rng):
    enc = rng.normal(size=(3, 6, 8)).astype(np.float32)
    enc[..., 7] = rng.uniform(0.05, 12, size=(3, 6))  # clamped both ways
    for hw in ((1024, 1024), (480, 640)):
        e, i = tcam.pose_encoding_to_extri_intri(_t(enc), hw)
        je, ji = jcam.pose_encoding_to_extri_intri(jnp.asarray(enc), hw)
        _close(e, je, 1e-5)
        _close(i, ji, 1e-3)  # pixel units, up to 5 x 1024
        back = tcam.extri_intri_to_pose_encoding(e, i, hw)
        _close(back, jcam.extri_intri_to_pose_encoding(je, ji, hw), 1e-5)
        # the round trip: frame 0 becomes the identity, the rest re-decode
        e2, i2 = tcam.pose_encoding_to_extri_intri(back, hw)
        _close(e2, e.numpy(), 1e-5)
        _close(i2, i.numpy(), 1e-3)
    torch.testing.assert_close(e[:, 0], torch.eye(3, 4).expand(3, 3, 4),
                               atol=1e-5, rtol=0)


# ------------------------------------------------- averaging and ranking

def test_average_camera_prediction(camera_pair):
    """Both sides' tiny f32 predictors as camera_forward on 4 frames of
    40 px (resized once to the predictor's 28 px), 3 query orderings."""
    p, sd, _ = camera_pair
    rng = np.random.default_rng(6)
    images = rng.uniform(size=(1, 4, 40, 40, 3)).astype(np.float32)
    jm = JCamera(**TINY)
    jfwd = jax.jit(lambda i: jm.apply(p, i, iters=2)["pred_pose_enc"])
    tm = _port_camera(sd, torch.float32)

    def tfwd(i):
        with torch.no_grad():
            return tm(i, iters=2)["pred_pose_enc"]

    qi = [0, 2, 3]
    je, ji = javg.average_camera_prediction(
        jfwd, jnp.asarray(images), (40, 40), query_indices=qi,
        model_input_size=28)
    te, ti = tavg.average_camera_prediction(
        tfwd, _t(images), (40, 40), query_indices=qi, model_input_size=28)
    _close(te, je, 1e-4)
    _close(ti, ji, 1e-3)
    np.testing.assert_allclose(te[0].numpy(), np.eye(3, 4), atol=1e-5)
    # the JAX error for a camera_forward that drops the orderings
    with pytest.raises(ValueError, match="Q=3"):
        tavg.average_camera_prediction(lambda i: tfwd(i)[:1], _t(images),
                                       (40, 40), query_indices=qi,
                                       model_input_size=28)


def test_average_rotations(rng):
    q = rng.normal(size=(4, 6, 4)).astype(np.float32)
    q[1:] = q[0] + 0.05 * q[1:]
    q[2] = -q[2]  # the other hemisphere
    R = np.asarray(jrot.quaternion_to_matrix(jnp.asarray(q)))
    _close(tavg.average_rotations(_t(R)),
           javg.average_rotations(jnp.asarray(R)), 1e-5)


def test_query_ranking(rng):
    for S, q in ((8, 8), (9, 3), (20, 5), (2, 4)):
        feats = rng.normal(size=(S, 16)).astype(np.float32)
        assert tavg.rank_by_dino_similarity(_t(feats), q) == \
            javg.rank_by_dino_similarity(jnp.asarray(feats), q)
        assert tavg.rank_by_midpoint(S, q) == javg.rank_by_midpoint(S, q)
        k = S // q + 1
        assert tavg.rank_by_interval(S, k) == javg.rank_by_interval(S, k)


def test_runner_query_rank_and_camera_init(camera_pair, camera_runs):
    """The runner's two stages with the tiny predictor in place: ranking
    by DINO descriptors, midpoint and interval; camera_init with and
    without averaging."""
    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner

    p, sd, images = camera_pair
    S = images.shape[1]
    jd = camera_runs["float32"][1]  # JAX descriptors of these frames
    want = {"dino": javg.rank_by_dino_similarity(jd[0], S)[:S],
            "mid": javg.rank_by_midpoint(S, S),
            "interval": javg.rank_by_interval(S, 2)[:S]}
    for name, flags in (("dino", {}), ("mid", {"query_by_midpoint": True}),
                        ("interval", {"query_by_interval": True})):
        runner = VGGSfMRunner(RunnerConfig(precision="f32",
                                           query_frame_num=S, **flags),
                              device="cpu")
        runner._camera = _port_camera(sd, torch.float32)
        got = runner.select_query_frames(images)
        assert got == want[name], name
        assert "query_rank" in runner.timings
    qi = want["dino"]
    jm = JCamera(**TINY)
    fwd = jax.jit(lambda i: jm.apply(p, i, iters=4)["pred_pose_enc"])
    je, ji = javg.average_camera_prediction(
        fwd, jnp.asarray(images), (28, 28), query_indices=qi,
        model_input_size=28)
    te, ti = runner.camera_init(images, qi)
    # four trunk iterations (two in the tests above) carry the f32
    # summation-order differences further: 5e-4 on the O(1-3) cameras
    _close(te, je, 5e-4)
    _close(ti, ji, 1e-3)
    assert "camera_init" in runner.timings
    runner.cfg.avg_pose = False
    te, ti = runner.camera_init(images, qi)
    with torch.no_grad():
        enc = runner.camera(_t(images), iters=4)["pred_pose_enc"]
    ref = tcam.pose_encoding_to_extri_intri(enc[0], (28, 28))
    torch.testing.assert_close((te, ti), ref, atol=0, rtol=0)
