"""The port's building blocks against the JAX package's, module by module,
at narrow widths on the same numpy inputs and weights (JAX params carried
over by the port's converter helpers). Everything runs in f32 on the CPU,
where the JAX modules take their plain jnp paths and the port's wrappers
their plain versions.

Tolerances: 1e-5 absolute for O(1) outputs of short f32 sums (sampling,
embeddings, norms); 1e-4 for outputs of deep stacks (convolution
encoders, transformer blocks), where summation order differs between XLA
and ATen over hundreds of terms per layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggsfm_tpu.models import embeddings as jemb
from vggsfm_tpu.models import encoders as jenc
from vggsfm_tpu.models import layers as jlay
from vggsfm_tpu.models import sampling as jsam
from vggsfm_tpu_torch.models import convert as cv
from vggsfm_tpu_torch.models import embeddings as temb
from vggsfm_tpu_torch.models import encoders as tenc
from vggsfm_tpu_torch.models import layers as tlay
from vggsfm_tpu_torch.models import sampling as tsam
from vggsfm_tpu_torch.ops import fused_mlp as tfm


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, fill, p):
    """Load JAX params `p` into `module` through a converter helper."""
    sd = {}
    fill(sd, "m", _np(p))
    module.load_state_dict({k[2:]: v for k, v in sd.items()})
    return module


def _close(out, ref, atol):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _randomize(p, rng, scale=0.1):
    """Replace every leaf (zero biases included) with random values."""
    return jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32) * scale
        + (1.0 if a.ndim == 1 and np.all(np.asarray(a) == 1) else 0.0)), p)


# ------------------------------------------------------------- attention

def test_mha_self_and_cross(rng):
    C, H = 32, 4
    q = rng.normal(size=(3, 5, C)).astype(np.float32)
    kv = rng.normal(size=(3, 9, C)).astype(np.float32)
    jm = jlay.TorchMultiheadAttention(C, H)
    p = _randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), q, kv, kv), rng)
    tm = _load(tlay.TorchMultiheadAttention(C, H), cv._mha, p["params"])
    _close(tm(torch.from_numpy(q), *[torch.from_numpy(kv)] * 2),
           jm.apply(p, q, kv, kv), 1e-5)
    tq = torch.from_numpy(q)
    _close(tm(tq, tq, tq), jm.apply(p, q, q, q), 1e-5)
    _close(tm.ln_self_attention(tq), jm.apply(p, q, q, q, fused_ln_self=True),
           1e-5)


@pytest.mark.parametrize("ln_residual", [False, True])
def test_mlp(rng, ln_residual):
    x = rng.normal(size=(4, 7, 32)).astype(np.float32) * 3
    jm = jlay.Mlp(64, 32)
    p = _randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), x), rng)
    tm = _load(tlay.Mlp(32, 64, 32), cv._mlp, p["params"])
    _close(tm(torch.from_numpy(x), ln_residual=ln_residual),
           jm.apply(p, x, ln_residual=ln_residual), 1e-5)


@pytest.mark.parametrize("L", [8, 9, 80])
def test_attn_block(rng, L):
    """f32 blocks run the two halves: fused_ln_attn for L <= 64, plain
    attention for L = 80, then fused_ln_mlp; both equal the JAX block."""
    C, H = 32, 4
    x = rng.normal(size=(5, L, C)).astype(np.float32) * 3
    jm = jlay.AttnBlock(C, H)
    p = _randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), x), rng)

    def fill(sd, pre, pp):
        cv._mha(sd, f"{pre}.attn", pp["attn"])
        cv._mlp(sd, f"{pre}.mlp", pp["mlp"])

    tm = _load(tlay.AttnBlock(C, H), fill, p["params"])
    assert not tfm.block_route_takes(torch.float32, C, L, H, 4 * C)
    assert tfm.ln_attn_takes(C, L, H) == (L <= 64)
    _close(tm(torch.from_numpy(x)), jm.apply(p, x), 1e-4)


def test_cross_attn_block(rng):
    C, H = 32, 4
    x = rng.normal(size=(3, 6, C)).astype(np.float32) * 3
    ctx = rng.normal(size=(3, 11, C)).astype(np.float32) * 2 + 1
    jm = jlay.CrossAttnBlock(C, H)
    p = _randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), x, ctx), rng)

    def fill(sd, pre, pp):
        cv._mha(sd, f"{pre}.cross_attn", pp["cross_attn"])
        sd[f"{pre}.norm_context.weight"] = cv._t(pp["norm_context"]["scale"])
        sd[f"{pre}.norm_context.bias"] = cv._t(pp["norm_context"]["bias"])
        cv._mlp(sd, f"{pre}.mlp", pp["mlp"])

    tm = _load(tlay.CrossAttnBlock(C, H), fill, p["params"])
    _close(tm(torch.from_numpy(x), torch.from_numpy(ctx)),
           jm.apply(p, x, ctx), 1e-4)


_BF, _F32 = torch.bfloat16, torch.float32


# (module dtype, token dtype, C, heads, mlp_ratio, L) -> the wrappers each
# layer calls: AttnBlock, Mlp(ln_residual=True), CrossAttnBlock
@pytest.mark.parametrize("mdt,xdt,C,H,ratio,L,block,mlp,cross", [
    # the coarse tracker: one block kernel; the tails on fused_ln_mlp
    (_BF, _BF, 384, 8, 4.0, 8, ["block"], ["mlp"], ["mlp"]),
    # the fine tracker's width
    (_BF, _BF, 256, 8, 4.0, 8, ["block"], ["mlp"], ["mlp"]),
    # 768 wide in bf16 (the camera's cross-attention tails): the halves,
    # the tail on the wide path
    (_BF, _BF, 768, 8, 4.0, 8, ["attn", "mlp"], ["mlp"], ["mlp"]),
    # f32 at 384 (the tracker's f32 precision): the attention half, then
    # the tail on fused_ln_mlp's f32 kernels
    (_F32, _F32, 384, 8, 4.0, 8, ["attn", "mlp"], ["mlp"], ["mlp"]),
    # the camera trunk: f32 tokens in a bf16 module stay f32, and f32
    # tails wider than 384 plain; its cross-attention rounds the tokens to
    # bf16 before the tail
    (_BF, _F32, 768, 8, 4.0, 8, ["attn"], [], ["mlp"]),
    # bf16 with head width 8: the halves, both on their kernels
    (_BF, _BF, 48, 6, 4.0, 8, ["attn", "mlp"], ["mlp"], ["mlp"]),
    # bf16 with hidden size 100: the attention half, then plain
    (_BF, _BF, 64, 4, 100 / 64, 8, ["attn"], [], []),
    # bf16 groups longer than 64: plain attention, then fused_ln_mlp
    (_BF, _BF, 64, 4, 4.0, 80, ["mlp"], ["mlp"], ["mlp"]),
], ids=["tracker-384", "fine-tracker-256", "bf16-768", "f32-384",
        "trunk-f32-768", "bf16-head-8", "bf16-hidden-100", "bf16-L-80"])
def test_layer_routes(monkeypatch, mdt, xdt, C, H, ratio, L, block, mlp,
                      cross):
    """Which fused former wrapper each layer calls, from the route
    predicates of ops/fused_mlp.py alone (on the CPU every wrapper runs
    its plain version)."""
    calls = []
    for name, key in (("fused_transformer_block", "block"),
                      ("fused_ln_attn", "attn"), ("fused_ln_mlp", "mlp")):
        def spy(*a, _fn=getattr(tlay, name), _key=key):
            calls.append(_key)
            return _fn(*a)
        monkeypatch.setattr(tlay, name, spy)
    g = torch.Generator().manual_seed(0)

    def init(m):
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
        return m

    x = torch.randn(2, L, C, generator=g).to(xdt)
    got = {}
    for layer, run in (
            ("block", lambda: init(tlay.AttnBlock(C, H, ratio, mdt))(x)),
            ("mlp", lambda: init(tlay.Mlp(C, int(C * ratio), C, mdt))(
                x, ln_residual=True)),
            ("cross", lambda: init(tlay.CrossAttnBlock(C, H, ratio, mdt))(
                x, x[:, :5]))):
        calls.clear()
        with torch.no_grad():
            run()
        got[layer] = list(calls)
    assert got == {"block": block, "mlp": mlp, "cross": cross}


# ----------------------------------------------------------- convolution

def test_norms(rng):
    x = rng.normal(size=(2, 9, 7, 5)).astype(np.float32) * 4 + 2
    _close(tlay.instance_norm(torch.from_numpy(x)), jlay.instance_norm(x),
           1e-5)
    y = rng.normal(size=(10, 16)).astype(np.float32) * 3
    s = rng.normal(size=16).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    _close(tlay.group_norm_1(*map(torch.from_numpy, (y, s, b))),
           jlay.group_norm_1(y, s, b), 1e-5)


@pytest.mark.parametrize("stride,hw", [(1, (12, 10)), (2, (12, 10)),
                                       (2, (13, 11))])
def test_residual_block(rng, stride, hw):
    cin = 8 if stride == 2 else 12  # no downsample: in == out channels
    x = rng.normal(size=(2, *hw, cin)).astype(np.float32)
    jm = jlay.ResidualBlock(12, stride)
    p = _randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), x), rng)
    tm = _load(tlay.ResidualBlock(cin, 12, stride), cv._residual_block,
               p["params"])
    out = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(out, jax.jit(jm.apply)(p, x), 1e-4)


@pytest.mark.parametrize("hw", [(64, 64), (66, 70)])
def test_basic_encoder(rng, hw):
    x = rng.uniform(size=(2, *hw, 3)).astype(np.float32)
    jm = jenc.BasicEncoder(output_dim=32, stride=4)
    p = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    tm = _load(tenc.BasicEncoder(32, 4), cv._basic_encoder, p["params"])
    ref = jax.jit(jm.apply)(p, x)
    out = tm(torch.from_numpy(x))
    assert tuple(out.shape) == ref.shape
    _close(out, ref, 1e-4)


@pytest.mark.parametrize("flat", [False, True])
def test_shallow_encoder(rng, flat):
    x = rng.uniform(size=(3, 31, 31, 3)).astype(np.float32)
    jm = jenc.ShallowEncoder(output_dim=8)
    p = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    tm = _load(tenc.ShallowEncoder(8), cv._shallow_encoder, p["params"])
    _close(tm(torch.from_numpy(x), flat_cfirst=flat),
           jax.jit(jm.apply, static_argnums=2)(p, x, flat), 1e-4)


# ------------------------------------------------- sampling, embeddings

@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_bilinear_sample(rng, mode):
    fmap = rng.normal(size=(2, 9, 11, 5)).astype(np.float32)
    # in-map, on-grid, half-outside and fully outside points
    coords = rng.uniform(-2, 12, size=(2, 4, 6, 2)).astype(np.float32)
    coords[0, 0, :3] = [[0, 0], [10, 8], [3, 4]]
    _close(tsam.bilinear_sample(torch.from_numpy(fmap),
                                torch.from_numpy(coords), mode),
           jsam.bilinear_sample(fmap, coords, mode), 1e-5)
    c2 = coords[:, 0]
    _close(tsam.sample_features4d(torch.from_numpy(fmap),
                                  torch.from_numpy(c2)),
           jsam.sample_features4d(fmap, c2), 1e-5)


@pytest.mark.parametrize("src,dst,ac", [(7, 13, True), (13, 7, True),
                                        (5, 1, True), (8, 3, False)])
def test_interp_matrix(src, dst, ac):
    _close(tsam._interp_matrix(src, dst, ac, torch.float32),
           jsam._interp_matrix(src, dst, ac, jnp.float32), 1e-6)


def test_interpolate_bilinear(rng):
    x = rng.normal(size=(2, 9, 6, 3)).astype(np.float32)
    for hw in ((17, 11), (4, 3), (9, 6)):
        _close(tsam.interpolate_bilinear(torch.from_numpy(x), hw),
               jsam.interpolate_bilinear(x, hw), 1e-5)
        _close(tsam.interpolate_bilinear_nchw(
            torch.from_numpy(x).permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1),
            jsam.interpolate_bilinear(x, hw), 1e-5)


def test_subpixel_parabola(rng):
    grid = rng.normal(size=(6, 3, 3)).astype(np.float32)
    grid[0] = 1.0  # flat neighbourhood: offset 0 via the guard

    def val_j(dy, dx):
        return jnp.asarray(grid)[:, 1 + dy, 1 + dx]

    def val_t(dy, dx):
        return torch.from_numpy(grid)[:, 1 + dy, 1 + dx]

    for a, b in zip(tsam.subpixel_parabola(val_t),
                    jsam.subpixel_parabola(val_j)):
        _close(a, b, 1e-6)


def test_embeddings(rng):
    for dim, grid in ((64, (5, 7)), (216, 31)):
        _close(temb.get_2d_sincos_pos_embed(dim, grid),
               jemb.get_2d_sincos_pos_embed(dim, grid), 1e-5)
    xy = rng.normal(size=(2, 5, 3, 2)).astype(np.float32) * 4
    for cat in (False, True):
        _close(temb.get_2d_embedding(torch.from_numpy(xy), 64, cat),
               jemb.get_2d_embedding(xy, 64, cat), 1e-4)
