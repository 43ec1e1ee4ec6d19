"""The port's correlation (ops/corr.py) against the JAX package.

* `corr_sample_plain`, and the CUDA source's device code built for the CPU
  against csrc/host_emu.h (the same arithmetic, indexing, shuffles and
  warp syncs as on the card), against `corr_sample_pallas` /
  `corr_sample_pallas_smallc` in interpret mode on the same numpy inputs,
  at the shapes of tests/test_corr_pallas.py (single-level calls: a list
  of one level). f32: atol 2e-4, rtol 1e-4, that file's tolerance (sums
  of up to 128 products in another order). bf16 maps: the port sums exact
  products in f32 where the TPU kernel rounds each product to bf16 first
  (2^-9 relative each, 32 products of O(1) values, scaled by 1/sqrt(32)):
  atol 2e-2.
* Both against the JAX gather path with tracks inside, across and far
  outside the borders (1e-5: short f32 sums), where the interpret-mode
  kernel differs: it clips the window into its padded map.
* The device code against the plain version over several levels, in both
  layouts (NHWC, flat channel-first read through its strides), f32 and
  bf16 maps and output, in every load variant.
* The port's `corr_sample` against `jtr.corr_sample` over its routes, in
  f32 (1e-5) and in bf16 within the map's rounding (`bf16_bound`).
* The wrapper's device rule: CPU tensors take the plain version and count no
  launch; any other device goes to the kernel's build and launch, which
  raise where there is no GPU. The kernel on the card:
  tests/test_torch_cuda.py and chip_smoke.py.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggsfm_tpu.models import tracker as jtr
from vggsfm_tpu.ops.corr_pallas import (
    corr_sample_pallas,
    corr_sample_pallas_smallc,
)
from vggsfm_tpu_torch.models import tracker as ttr
from vggsfm_tpu_torch.ops import _build, launch_counts, reset_launch_counts
from vggsfm_tpu_torch.ops import corr as tc

_DT = {torch.float32: 0, torch.bfloat16: 1}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def emu():
    try:
        return _build.load_host_emulation()
    except RuntimeError as e:  # no host C++ compiler
        pytest.skip(str(e))


def _emulated(lib, levels, coords, feats, r, out_dtype=torch.float32):
    """The device code on the CPU: levels (F, H_i, W_i, C) of any strides,
    coords (F, N, 2), feats (F, N, C) -> (F, N, L (2r+1)^2)."""
    F, N, _ = coords.shape
    C, L = feats.shape[-1], len(levels)
    out = torch.empty(F, N, L * (2 * r + 1) ** 2, dtype=out_dtype)
    rc = lib.vf_corr_sample(
        _DT[levels[0].dtype], int(out_dtype == torch.bfloat16), L,
        *_table(levels), coords.data_ptr(), feats.data_ptr(),
        feats.stride(0), feats.stride(1), out.data_ptr(), F, N, C, r)
    assert rc == 0, rc
    return out


def _table(levels):
    """The level table: pointers, (H, W) pairs, (F, H, W, C) strides."""
    L = len(levels)
    return ((ctypes.c_longlong * L)(*[lv.data_ptr() for lv in levels]),
            (ctypes.c_int * (2 * L))(*[s for lv in levels
                                       for s in lv.shape[1:3]]),
            (ctypes.c_longlong * (4 * L))(*[s for lv in levels
                                            for s in lv.stride()]))


def _variant(lib, levels, C):
    return lib.vf_corr_variant(_DT[levels[0].dtype], len(levels),
                               *_table(levels), C)


def bf16_bound(levels, coords, feats, r):
    """Per tap, how far a bf16 route may lie from the f32 value: 2^-5 x the
    largest sum of |products| (sum_c |m_c f_c|) over the four cells the tap
    combines, / sqrt(C). Error budget in units of u = 2^-9 (bf16's unit
    roundoff) of that sum A: the JAX routes round each product (the N == 1
    route) or each dot (the map product, the gather) to bf16, 1 u; the
    sub-cell offsets and their complements in bf16, ~3 u through the
    weights; the combine's products and sums in bf16, ~5 u; the divide by
    bf16 sqrt(C), 2 u; the kernel's single rounding, 1 u: ~12 u of 16. The
    same inputs, measured: at most ~8 u against the window's |dots|."""
    F, N, C = feats.shape
    w, W1 = 2 * r + 2, 2 * r + 1
    frame = torch.arange(F)[:, None, None]
    out = []
    for i, lv in enumerate(levels):
        H, W = lv.shape[1:3]
        idx, ok, _ = tc.window_index(coords.float() / 2 ** i, r, H, W)
        nb = lv[frame, idx // W, idx % W].float().abs() * ok[..., None]
        a = torch.einsum("fnkc,fnc->fnk", nb, feats.float().abs())
        a = a.reshape(F, N, w, w)
        m = torch.maximum(torch.maximum(a[..., :W1, :W1], a[..., :W1, 1:]),
                          torch.maximum(a[..., 1:, :W1], a[..., 1:, 1:]))
        out.append(m.reshape(F, N, -1))
    return 2.0 ** -5 * torch.cat(out, -1) / C ** 0.5


def one_rounding(ref):
    """Half a bf16 ulp of |ref| (|ref| = m 2^e, m in [.5, 1): ulp 2^(e-8)),
    plus 1e-5 for the f32 sums' order: how far a bf16 output may lie from
    the f32 value it rounds."""
    _, e = torch.frexp(ref.float().abs())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 9) + 1e-5


def _inputs(rng, S, H, W, C, N, lo, hi, fixed=None):
    fmap = rng.normal(size=(S, H, W, C)).astype(np.float32)
    coords = rng.uniform(lo, hi, size=(S, N, 2)).astype(np.float32)
    if fixed is not None:
        coords[0, :len(fixed)] = np.float32(fixed)
    feats = rng.normal(size=(S, N, C)).astype(np.float32)
    return fmap, coords, feats


BORDER_128 = [[0.5, 0.5], [15.2, 15.7], [1.0, 14.0], [14.9, 0.1]]
BORDER_32 = [[0.3, 0.4], [14.2, 14.6], [0.9, 13.5], [13.8, 0.2], [7.5, 7.5]]

# the cases of tests/test_corr_pallas.py: (S, H, W, C, N, r, lo, hi, fixed)
PALLAS_CASES = [
    pytest.param((2, 32, 32, 128, 24, 4, 5, 26, None), id="inside"),
    pytest.param((1, 16, 16, 128, 4, 3, 0, 1, BORDER_128), id="borders"),
    pytest.param((1, 32, 32, 128, 13, 4, 6, 25, None), id="ragged-N"),
]
SMALLC_CASES = [
    pytest.param((4, 31, 31, 32, 9, 3, 4, 26, None), id="inside"),
    pytest.param((1, 15, 15, 32, 5, 3, 0, 1, BORDER_32), id="borders"),
]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_plain_and_device_code_match_corr_sample_pallas(rng, emu, case):
    S, H, W, C, N, r, lo, hi, fixed = case
    fmap, coords, feats = _inputs(rng, S, H, W, C, N, lo, hi, fixed)
    ref = np.asarray(corr_sample_pallas(
        jnp.asarray(fmap), jnp.asarray(coords), jnp.asarray(feats),
        radius=r, interpret=True))
    plain = tc.corr_sample_plain([_t(fmap)], _t(coords), _t(feats), r)
    assert plain.dtype == torch.float32 and plain.shape == ref.shape
    np.testing.assert_allclose(plain.numpy(), ref, atol=2e-4, rtol=1e-4)
    dev = _emulated(emu, [_t(fmap)], _t(coords), _t(feats), r)
    np.testing.assert_allclose(dev.numpy(), ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SMALLC_CASES)
def test_plain_and_device_code_match_corr_sample_pallas_smallc(rng, emu, case,
                                                               dtype):
    S, H, W, C, N, r, lo, hi, fixed = case
    fmap, coords, feats = _inputs(rng, S, H, W, C, N, lo, hi, fixed)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(corr_sample_pallas_smallc(
        jnp.asarray(fmap).astype(jdt), jnp.asarray(coords),
        jnp.asarray(feats).astype(jdt), radius=r, interpret=True))
    tol = (dict(atol=2e-4, rtol=1e-4) if dtype == torch.float32
           else dict(atol=2e-2, rtol=0))
    tfm, tft = _t(fmap).to(dtype), _t(feats).to(dtype)
    plain = tc.corr_sample_plain([tfm], _t(coords), tft, r)
    assert plain.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), ref, **tol)
    dev = _emulated(emu, [tfm], _t(coords), tft, r)
    np.testing.assert_allclose(dev.numpy(), ref, **tol)
    # the two versions of the port sum the same exact products in f32
    np.testing.assert_allclose(dev.numpy(), plain.numpy(), atol=1e-5)


# positions inside, on integer cells, on and across every border, with
# negative and exactly-integer coordinates, and far outside the map
EDGE = [[3.0, 4.0], [0.0, 0.0], [-0.0, 11.0], [-1.0, 5.5], [-0.25, -0.75],
        [13.0, 11.0], [13.6, 11.4], [12.999, 0.001], [-3.5, 6.0],
        [16.5, 14.5], [-40.0, 5.0], [7.0, 300.5], [1e4, -1e4]]


@pytest.mark.parametrize("C,r,vec", [(128, 4, True), (32, 3, True),
                                     (20, 2, True), (33, 1, False)])
def test_plain_and_device_code_match_the_jax_gather_path(rng, emu, C, r, vec):
    """C = 33 takes the device code's element-by-element loads, the others
    its 16-byte packs (the library's own choice, `vf_corr_variant`)."""
    S, H, W, N = 2, 12, 14, len(EDGE) + 4
    assert (C % 4 == 0) == vec
    fmap, coords, feats = _inputs(rng, S, H, W, C, N, -6, 20, EDGE)
    assert (_variant(emu, [_t(fmap)], C) == VEC_ONE) == vec
    want = np.asarray(jtr.corr_sample(
        [jnp.asarray(fmap)[None]], jnp.asarray(coords)[None],
        jnp.asarray(feats)[None], radius=r))[0]
    plain = tc.corr_sample_plain([_t(fmap)], _t(coords), _t(feats), r)
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5)
    dev = _emulated(emu, [_t(fmap)], _t(coords), _t(feats), r)
    np.testing.assert_allclose(dev.numpy(), want, atol=1e-5)
    far = [EDGE.index(p) for p in ([-40.0, 5.0], [7.0, 300.5], [1e4, -1e4])]
    assert not dev[0, far].any() and not plain[0, far].any()


def test_far_outside_window_is_zero_where_the_tpu_kernel_shifts_it(rng):
    """The gather path (the documented contract) zeroes every cell outside
    the map wherever the window lies, and so does the port. The TPU kernel
    clips the window's corner into its map padded by r + 2 cells, so from
    floor(x) = -3 down (and from W + 1 up) it returns the taps of a shifted
    window: different values at -2.5, where some taps are still inside,
    and non-zero ones at -40, where none is. Up to floor(x) = -2 the two
    agree."""
    S, H, W, C, r = 1, 16, 16, 128, 3
    fmap, coords, feats = _inputs(
        rng, S, H, W, C, 4, 0, 1,
        [[-40.0, 5.2], [-2.5, 5.2], [-1.5, 5.2], [6.3, 5.2]])
    args = (jnp.asarray(fmap), jnp.asarray(coords), jnp.asarray(feats))
    kernel = np.asarray(corr_sample_pallas(*args, radius=r, interpret=True))
    gather = np.asarray(jtr.corr_sample([args[0][None]], args[1][None],
                                        args[2][None], radius=r))[0]
    port = tc.corr_sample_plain([_t(fmap)], _t(coords), _t(feats),
                                r).numpy()
    np.testing.assert_allclose(port, gather, atol=1e-5)
    assert not gather[0, 0].any() and not port[0, 0].any()
    assert np.abs(kernel[0, 0]).max() > 0.1  # the shifted window
    assert np.abs(gather[0, 1]).max() > 0.1  # taps still inside the map
    assert np.abs(kernel[0, 1] - gather[0, 1]).max() > 0.1
    np.testing.assert_allclose(kernel[0, 2:], gather[0, 2:], atol=2e-4)


@pytest.mark.parametrize("C", [16, 32, 128])
@pytest.mark.parametrize("N", [1, 2, 10, 63, 70])
def test_corr_sample_matches_jax_on_every_route(rng, N, C):
    """The JAX function's three routes (N = 70: the full-map product; N =
    1 with C < 128: the full-map reduce; the rest: the gather) against the
    port's one (the kernel's plain version on the CPU)."""
    B, S, H, W, r = 1, 2, 12, 14, 3
    fmaps = rng.normal(size=(B, S, H, W, C)).astype(np.float32)
    coords = rng.uniform(-3, 16, size=(B, S, N, 2)).astype(np.float32)
    feats = rng.normal(size=(B, S, N, C)).astype(np.float32)
    jp = jtr.build_corr_pyramid(jnp.asarray(fmaps), 3)
    ref = jtr.corr_sample(jp, jnp.asarray(coords), jnp.asarray(feats), r)
    tp = ttr.build_corr_pyramid(_t(fmaps), 3)
    assert all(level.is_contiguous() for level in tp)
    out = ttr.corr_sample(tp, _t(coords), _t(feats), r)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_corr_sample_keeps_the_features_dtype(rng):
    """bf16 tracker: the kernel returns the features' dtype, as both JAX
    call sites do, rounding its f32 taps once."""
    fmaps = _t(rng.normal(size=(1, 2, 12, 14, 32)).astype(np.float32))
    coords = _t(rng.uniform(0, 12, size=(1, 2, 5, 2)).astype(np.float32))
    feats = _t(rng.normal(size=(1, 2, 5, 32)).astype(np.float32))
    tp = ttr.build_corr_pyramid(fmaps.bfloat16(), 2)
    out = ttr.corr_sample(tp, coords, feats.bfloat16(), 3)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 5, 2 * 49)
    ref = ttr.corr_sample(ttr.build_corr_pyramid(fmaps.bfloat16().float(), 2),
                          coords, feats.bfloat16().float(), 3)
    # one rounding of O(1-4) outputs to bf16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2)


def test_wrapper_takes_plain_version_on_cpu_only(rng):
    fmap, coords, feats = _inputs(rng, 2, 8, 8, 32, 3, 0, 7)
    reset_launch_counts()
    out = tc.corr_sample_kernel([_t(fmap)], _t(coords), _t(feats), 3)
    assert torch.equal(out, tc.corr_sample_plain([_t(fmap)], _t(coords),
                                                 _t(feats), 3))
    assert not any(launch_counts.values())
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    # off the CPU the wrapper goes to the kernel: its build raises here
    meta = [torch.empty(s, device="meta") for s in (fmap.shape, coords.shape,
                                                    feats.shape)]
    with pytest.raises(RuntimeError, match="nvcc"):
        tc.corr_sample_kernel([meta[0]], *meta[1:], 3)
    assert not any(launch_counts.values())


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    def call(C=32, dtype=torch.float32, r=3, cdtype=torch.float32,
             fdtype=None, levels=1, out_dtype=torch.float32):
        return tc.corr_sample_kernel(
            [torch.empty(2, 8, 8, C, dtype=dtype, device="meta")] * levels,
            torch.empty(2, 3, 2, dtype=cdtype, device="meta"),
            torch.empty(2, 3, C, dtype=fdtype or dtype, device="meta"), r,
            out_dtype=out_dtype)

    with pytest.raises(TypeError):
        call(dtype=torch.float16)
    with pytest.raises(TypeError):
        call(cdtype=torch.bfloat16)
    with pytest.raises(TypeError):  # features in another dtype than maps
        call(C=128, dtype=torch.bfloat16, fdtype=torch.float32)
    with pytest.raises(TypeError):
        call(out_dtype=torch.float16)
    with pytest.raises(ValueError):
        call(C=4096)
    with pytest.raises(ValueError):
        call(r=8)
    with pytest.raises(ValueError):
        call(levels=tc.MAX_LEVELS + 1)
    with pytest.raises(ValueError, match="contiguous"):
        tc.corr_sample_kernel(
            [torch.empty(2, 8, 8, 32, device="meta")],
            torch.empty(2, 2, 3, device="meta").transpose(1, 2),
            torch.empty(2, 3, 32, device="meta"), 3)
    with pytest.raises(ValueError, match="channel stride"):
        tc.corr_sample_kernel(
            [torch.empty(2, 8, 8, 32, device="meta")],
            torch.empty(2, 3, 2, device="meta"),
            torch.empty(2, 32, 3, device="meta").transpose(1, 2), 3)


def test_device_code_rejects_shapes_and_fits_shared_memory(emu):
    p = torch.zeros(64).data_ptr()
    ptrs, hw, strides = _table([torch.zeros(2, 8, 8, 32)])

    def rc(dtype=0, L=1, hw=hw, strides=strides, F=2, N=3, C=32, r=3):
        return emu.vf_corr_sample(dtype, 0, L, ptrs, hw, strides, p, p, C,
                                  N * C, p, F, N, C, r)

    assert rc(F=0) == -1 and rc(N=0) == -1
    assert rc(C=4096) == -2
    assert rc(r=8) == -3
    assert rc(hw=(ctypes.c_int * 2)(0, 8)) == -4
    assert rc(L=0) == -7 and rc(L=tc.MAX_LEVELS + 1) == -7
    assert rc(dtype=2) == -100
    # neither every channel stride 1 nor every column stride 1
    assert rc(strides=(ctypes.c_longlong * 4)(2048, 256, 32, 2)) == -6
    # static launch limit of dynamic shared memory: 48 KB
    for flat in (0, 1):
        for C in (tc.MAX_C, tc.MAX_C - 1, 128, 32):
            assert emu.vf_corr_smem_bytes(C, tc.MAX_RADIUS, flat) <= 49152


# vcorr::Variant
FLAT, VEC_ONE, SCALAR_ONE, SCALAR_MULTI = range(4)


def _levels(rng, F, dims, C, dtype, flat):
    """Maps (F, H, W, C) per level: NHWC, or views of flat channel-first
    (F, C, H*W) storage (column stride 1), as the tracker keeps each."""
    out = []
    for H, W in dims:
        if flat:
            x = _t(rng.normal(size=(F, C, H * W)).astype(np.float32))
            out.append(x.to(dtype).view(F, C, H, W).permute(0, 2, 3, 1))
        else:
            x = _t(rng.normal(size=(F, H, W, C)).astype(np.float32))
            out.append(x.to(dtype))
    return out


def _tracks(rng, F, N, C, W, dtype):
    """Positions inside, on integer cells, across every border and far
    outside the level-0 map of width W; features in the maps' dtype."""
    coords = rng.uniform(-6, W + 6, size=(F, N, 2)).astype(np.float32)
    edge = [[3.0, 4.0], [0.0, 0.0], [-1.0, W - 1.0], [W - 0.5, -0.25],
            [-40.0, 5.0], [7.0, 1e4]]
    coords[0, :len(edge)] = edge[:N]
    feats = _t(rng.normal(size=(F, N, C)).astype(np.float32)).to(dtype)
    return _t(coords), feats


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["out-f32", "out-bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["maps-f32", "maps-bf16"])
@pytest.mark.parametrize("flat", [False, True], ids=["nhwc", "flat"])
def test_device_code_matches_plain_over_levels(rng, emu, flat, dtype,
                                               out_dtype):
    """The tracker's two shapes, cut down: NHWC C = 128, r = 4, 4 levels,
    the last (3x3) smaller than the 10x10 window; flat C = 32, r = 3, 3
    levels of 15^2, 7^2 and 3^2, read in place through their strides.
    f32 output: 1e-5 (short f32 sums in another order); bf16: one rounding
    of the plain f32 value. Tracks far outside read zeros."""
    C, r, dims = ((32, 3, [(15, 15), (7, 7), (3, 3)]) if flat else
                  (128, 4, [(24, 20), (12, 10), (6, 5), (3, 3)]))
    F, N = 3, 9
    levels = _levels(rng, F, dims, C, dtype, flat)
    assert _variant(emu, levels, C) == (FLAT if flat else VEC_ONE)
    coords, feats = _tracks(rng, F, N, C, dims[0][1], dtype)
    ref = tc.corr_sample_plain(levels, coords, feats, r)
    assert ref.shape == (F, N, len(dims) * (2 * r + 1) ** 2)
    dev = _emulated(emu, levels, coords, feats, r, out_dtype)
    assert dev.dtype == out_dtype
    err = (dev.float() - ref).abs()
    if out_dtype == torch.float32:
        assert float(err.max()) <= 1e-5
    else:
        assert bool((err <= one_rounding(ref)).all())
        np.testing.assert_array_equal(
            tc.corr_sample_plain(levels, coords, feats, r, out_dtype).float(),
            ref.to(out_dtype).float())
    assert not dev[0, 4:6].any() and not ref[0, 4:6].any()


@pytest.mark.parametrize("C,dtype,variant", [
    (512, torch.bfloat16, SCALAR_MULTI), (600, torch.float32, SCALAR_MULTI),
    (33, torch.float32, SCALAR_MULTI),
    (20, torch.bfloat16, SCALAR_ONE), (16, torch.bfloat16, VEC_ONE),
    (8, torch.bfloat16, VEC_ONE), (1, torch.float32, SCALAR_ONE)])
def test_device_code_load_variants(rng, emu, C, dtype, variant):
    """Every NHWC load variant: element loads over one channel chunk or
    several (C wider than 16 bytes a lane, 512 bf16 and 600 f32, takes
    them too), 16-byte packs, and cells
    shared by 2 lanes (C = 16 bf16) or held by one (C = 8 bf16, C = 1),
    where the butterfly gives way to the plain reduction."""
    F, N, r, dims = 2, 7, 2, [(12, 14), (6, 7)]
    levels = _levels(rng, F, dims, C, dtype, False)
    assert _variant(emu, levels, C) == variant
    coords, feats = _tracks(rng, F, N, C, 14, dtype)
    ref = tc.corr_sample_plain(levels, coords, feats, r)
    dev = _emulated(emu, levels, coords, feats, r)
    assert float((dev - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [32, 64])
def test_corr_sample_matches_jax_in_both_dtypes(rng, N, dtype):
    """N = 32: the JAX gather route; N = 64: its full-map product. Both
    get the same pyramid (JAX's, in the dtype). f32: 1e-5; bf16: the JAX
    routes round the dots (map or gather) and the combine's steps to bf16,
    the port once at the end: `bf16_bound`."""
    B, S, H, W, C, r = 1, 2, 24, 20, 128, 4
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    fm = rng.normal(size=(B, S, H, W, C)).astype(np.float32)
    coords = rng.uniform(-3, 24, size=(B, S, N, 2)).astype(np.float32)
    jp = jtr.build_corr_pyramid(jnp.asarray(fm).astype(jdt), 3)
    jf = jnp.asarray(rng.normal(size=(B, S, N, C))).astype(jdt)
    ref = _t(np.asarray(jtr.corr_sample(jp, jnp.asarray(coords), jf, r)
                        ).astype(np.float32))
    tp = [_t(np.asarray(lv).astype(np.float32)).to(dtype) for lv in jp]
    tf = _t(np.asarray(jf).astype(np.float32)).to(dtype)
    out = ttr.corr_sample(tp, _t(coords), tf, r)
    assert out.dtype == dtype and out.shape == ref.shape
    err = (out.float() - ref).abs()[0]
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5
    else:
        bound = bf16_bound([lv[0] for lv in tp], _t(coords)[0], tf[0], r)
        assert bool((err <= bound).all()), float((err / bound).max())


def test_tracker_pyramids_take_one_layout(emu):
    """The coarse pyramid of maps in any memory layout (a CNN's channels-
    last output, a frame reorder) is NHWC at every level, and the flat fine
    pyramid channel-first at every level, as one launch needs."""
    nchw = torch.zeros(1, 2, 4, 16, 16).permute(0, 1, 3, 4, 2)  # B S H W C
    pyr = ttr.build_corr_pyramid(nchw[:, [1, 0]], 3)
    levels = [lv.reshape(2, *lv.shape[2:]) for lv in pyr]
    assert _variant(emu, levels, 4) in (VEC_ONE, SCALAR_ONE)
    flat, hws = ttr.build_corr_pyramid_flat(torch.zeros(1, 2, 4, 256),
                                            (16, 16), 3)
    maps = [lv.reshape(2, 4, H, W).permute(0, 2, 3, 1)
            for lv, (H, W) in zip(flat, hws)]
    assert _variant(emu, maps, 4) == FLAT
