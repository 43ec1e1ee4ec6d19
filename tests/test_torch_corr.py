"""The port's few-track correlation (ops/corr.py) against the JAX package.

* `corr_sample_plain`, and the CUDA source's device code built for the CPU
  against csrc/host_emu.h (the same arithmetic, indexing and barriers as on
  the card), against `corr_sample_pallas` / `corr_sample_pallas_smallc` in
  interpret mode on the same numpy inputs, at the shapes of
  tests/test_corr_pallas.py. f32: atol 2e-4, rtol 1e-4, that file's
  tolerance (sums of up to 128 products in another order). bf16 maps: the
  port sums exact products in f32 where the TPU kernel rounds each product
  to bf16 first (2^-9 relative each, 32 products of O(1) values, scaled by
  1/sqrt(32)): atol 2e-2.
* Both against the JAX gather path with tracks inside, across and far
  outside the borders (1e-5: short f32 sums), where the interpret-mode
  kernel differs: it clips the window into its padded map.
* The port's `corr_sample` against `jtr.corr_sample` over its three routes.
* The wrapper's device rule: CPU tensors take the plain version and count no
  launch; any other device goes to the kernel's build and launch, which
  raise where there is no GPU. The kernel on the card:
  tests/test_torch_cuda.py and chip_smoke.py.
"""

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


def _emulated(lib, fmap, coords, feats, r):
    S, H, W, C = fmap.shape
    N = coords.shape[1]
    out = torch.empty(S, N, (2 * r + 1) ** 2)
    rc = lib.vf_corr_sample(_DT[fmap.dtype], fmap.data_ptr(),
                            coords.data_ptr(), feats.data_ptr(),
                            out.data_ptr(), S, N, H, W, C, r)
    assert rc == 0
    return out


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
    plain = tc.corr_sample_plain(_t(fmap), _t(coords), _t(feats), r)
    assert plain.dtype == torch.float32 and plain.shape == ref.shape
    np.testing.assert_allclose(plain.numpy(), ref, atol=2e-4, rtol=1e-4)
    dev = _emulated(emu, _t(fmap), _t(coords), _t(feats), r)
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
    plain = tc.corr_sample_plain(tfm, _t(coords), tft, r)
    assert plain.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), ref, **tol)
    dev = _emulated(emu, tfm, _t(coords), tft, r)
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
    its 16-byte packs (the flag mirrors the library's choice)."""
    S, H, W, N = 2, 12, 14, len(EDGE) + 4
    assert (C % 4 == 0) == vec
    fmap, coords, feats = _inputs(rng, S, H, W, C, N, -6, 20, EDGE)
    want = np.asarray(jtr.corr_sample(
        [jnp.asarray(fmap)[None]], jnp.asarray(coords)[None],
        jnp.asarray(feats)[None], radius=r))[0]
    plain = tc.corr_sample_plain(_t(fmap), _t(coords), _t(feats), r)
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5)
    dev = _emulated(emu, _t(fmap), _t(coords), _t(feats), r)
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
    port = tc.corr_sample_plain(_t(fmap), _t(coords), _t(feats), r).numpy()
    np.testing.assert_allclose(port, gather, atol=1e-5)
    assert not gather[0, 0].any() and not port[0, 0].any()
    assert np.abs(kernel[0, 0]).max() > 0.1  # the shifted window
    assert np.abs(gather[0, 1]).max() > 0.1  # taps still inside the map
    assert np.abs(kernel[0, 1] - gather[0, 1]).max() > 0.1
    np.testing.assert_allclose(kernel[0, 2:], gather[0, 2:], atol=2e-4)


@pytest.mark.parametrize("C", [16, 32, 128])
@pytest.mark.parametrize("N", [1, 2, 10, 63, 70])
def test_corr_sample_matches_jax_on_every_route(rng, N, C):
    """N = 70: the full-map product; N = 1 with C < 128: the full-map
    reduce; the rest: the kernel route (its plain version on the CPU),
    float32 at C = 128 and the map's dtype below."""
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
    """bf16 tracker: the kernel route returns f32, cast to the features'
    dtype as both JAX call sites do."""
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
    out = tc.corr_sample_kernel(_t(fmap), _t(coords), _t(feats), 3)
    assert torch.equal(out, tc.corr_sample_plain(_t(fmap), _t(coords),
                                                 _t(feats), 3))
    assert not any(launch_counts.values())
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    # off the CPU the wrapper goes to the kernel: its build raises here
    meta = [torch.empty(s, device="meta") for s in (fmap.shape, coords.shape,
                                                    feats.shape)]
    with pytest.raises(RuntimeError, match="nvcc"):
        tc.corr_sample_kernel(*meta, 3)
    assert not any(launch_counts.values())


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    def call(C=32, dtype=torch.float32, r=3, cdtype=torch.float32):
        return tc.corr_sample_kernel(
            torch.empty(2, 8, 8, C, dtype=dtype, device="meta"),
            torch.empty(2, 3, 2, dtype=cdtype, device="meta"),
            torch.empty(2, 3, C, dtype=dtype, device="meta"), r)

    with pytest.raises(TypeError):
        call(C=128, dtype=torch.bfloat16)  # bf16 only below C = 128
    with pytest.raises(TypeError):
        call(dtype=torch.float16)
    with pytest.raises(TypeError):
        call(cdtype=torch.bfloat16)
    with pytest.raises(ValueError):
        call(C=4096)
    with pytest.raises(ValueError):
        call(r=8)
    with pytest.raises(ValueError, match="contiguous"):
        tc.corr_sample_kernel(
            torch.empty(2, 8, 32, 8, device="meta").transpose(2, 3),
            torch.empty(2, 3, 2, device="meta"),
            torch.empty(2, 3, 32, device="meta"), 3)


def test_device_code_rejects_shapes_and_fits_shared_memory(emu):
    p = torch.zeros(8).data_ptr()
    assert emu.vf_corr_sample(0, p, p, p, p, 0, 3, 8, 8, 32, 3) == -1
    assert emu.vf_corr_sample(0, p, p, p, p, 2, 3, 8, 8, 4096, 3) == -2
    assert emu.vf_corr_sample(0, p, p, p, p, 2, 3, 8, 8, 32, 8) == -3
    assert emu.vf_corr_sample(0, p, p, p, p, 2, 3, 0, 8, 32, 3) == -4
    assert emu.vf_corr_sample(2, p, p, p, p, 2, 3, 8, 8, 32, 3) == -100
    # static launch limit of dynamic shared memory: 48 KB
    for tsize in (2, 4):
        assert emu.vf_corr_smem_bytes(tc.MAX_C, tc.MAX_RADIUS,
                                      tsize) <= 49152
        assert emu.vf_corr_smem_bytes(tc.MAX_C - 1, tc.MAX_RADIUS,
                                      tsize) <= 49152
