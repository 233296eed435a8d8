"""The plain-JAX main paths against float64 numpy references: FastCl,
every binning strategy (the Pallas GPU kernel in interpret mode), the
B-spline lens gather, the fused ILC coadds, LensedQEPipeline, and the
chip smoke test's phases at tiny sizes."""
import functools
import math
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from orphics_tpu import rect_geometry
from orphics_tpu.ops import binning
from orphics_tpu.ops.binning import Bin2D, RfftBin2D
from orphics_tpu.ops.bin_kernel import bin_sums

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (ny, nx): square, non-square, and not a power of two
SHAPES = [(64, 64), (48, 80), (100, 100)]


def _geom(shape, px=4.0):
    ny, nx = shape
    return rect_geometry(width_arcmin=nx * px, height_arcmin=ny * px,
                         px_res_arcmin=px)


def _np_binned(p_full, ml, edges):
    """float64 reference: full-plane digitize + bincount means."""
    dig = np.digitize(ml.ravel(), edges, right=True)
    nb = len(edges) - 1
    cnt = np.bincount(dig, minlength=nb + 2)[1:-1]
    out = []
    for p in p_full.reshape(-1, ml.size):
        s = np.bincount(dig, weights=p, minlength=nb + 2)[1:-1]
        out.append(s / np.maximum(cnt, 1))
    return np.stack(out)


# ---------------------------------------------------------------------------
# FastCl
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", ["map", "cross", "sim"])
def test_fastcl_vs_numpy(shape, method):
    from orphics_tpu.maps import FastCl
    from orphics_tpu.models import grf
    geom = _geom(shape)
    ml = geom.modlmap_np()
    edges = np.arange(100, 2600, 150.0)
    ells = np.arange(6000.0)
    cl = 1e3 / (ells + 80.0) ** 2
    fc = FastCl(geom, ells, cl, bin_edges=edges)
    norm = float(geom.area) / float(geom.npix) ** 2
    rng = np.random.default_rng(3)
    m1 = rng.standard_normal((3,) + shape).astype(np.float32)
    m2 = rng.standard_normal((3,) + shape).astype(np.float32)
    f1 = np.fft.fft2(m1.astype(np.float64))
    if method == "map":
        got = fc.map_bandpowers(m1)
        ref = _np_binned(np.abs(f1) ** 2 * norm, ml, edges)
    elif method == "cross":
        got = fc.cross_bandpowers(m1, m2)
        f2 = np.fft.fft2(m2.astype(np.float64))
        ref = _np_binned((f1 * f2.conj()).real * norm, ml, edges)
    else:
        key = jax.random.PRNGKey(5)
        got = fc.sim_bandpowers(key, 3)
        # same noise draws, synthesized and analysed in float64 numpy
        eta = np.stack([np.asarray(grf.rand_hermitian_half(k, geom))
                        for k in jax.random.split(key, 3)])
        csq = np.sqrt(np.interp(ml[:, :shape[1] // 2 + 1], ells, cl,
                                left=0, right=0)) * (
            geom.npix / float(geom.area) ** 0.5)
        maps = np.fft.irfft2(csq * eta.astype(np.complex128), s=shape)
        ref = _np_binned(np.abs(np.fft.fft2(maps)) ** 2 * norm, ml, edges)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-5,
                               atol=1e-6 * np.abs(ref).max())


def test_fastcl_int_seed_is_a_key():
    from orphics_tpu.maps import FastCl
    geom = _geom((64, 64))
    ells = np.arange(6000.0)
    fc = FastCl(geom, ells, 1e3 / (ells + 80.0) ** 2,
                bin_edges=np.arange(100, 2600, 150.0))
    a = np.asarray(fc.sim_bandpowers(7, 2))
    b = np.asarray(fc.sim_bandpowers(jax.random.PRNGKey(7), 2))
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="ells, cl1d"):
        FastCl(geom, bin_edges=np.arange(100, 2600, 150.0)
               ).sim_bandpowers(0, 2)


# ---------------------------------------------------------------------------
# Binning strategies and the GPU kernel
# ---------------------------------------------------------------------------

# "triton" off CUDA takes its plain fallback; "triton-interpret" runs the
# kernel itself in Pallas interpret mode
BIN_CASES = ("triton-interpret",) + binning.STRATEGIES


def _binner(cls, monkeypatch, *args, strategy):
    if strategy != "triton-interpret":
        return cls(*args, strategy=strategy)
    monkeypatch.setattr(binning, "bin_sums",
                        functools.partial(bin_sums, interpret=True))
    b = cls(*args, strategy="triton")
    b.sum = b._kernel_sum
    return b


@pytest.mark.parametrize("strategy", BIN_CASES)
@pytest.mark.parametrize("kind", ["bin2d", "bin2d_weighted", "rfft"])
def test_binning_strategies_vs_bincount(strategy, kind, monkeypatch):
    geom = _geom((48, 80))
    ml = geom.modlmap_np()
    edges = np.arange(100, 2600, 150.0)
    rng = np.random.default_rng(11)
    if kind == "rfft":
        img = rng.standard_normal((2,) + geom.shape)
        p_full = np.abs(np.fft.fft2(img)) ** 2
        p_half = np.abs(np.fft.rfft2(img)) ** 2
        b = _binner(RfftBin2D, monkeypatch, geom, edges, strategy=strategy)
        got = b.bin(jnp.asarray(p_half, jnp.float32))[1]
        ref = _np_binned(p_full, ml, edges)
    else:
        data = rng.exponential(size=(3,) + geom.shape)
        b = _binner(Bin2D, monkeypatch, ml, edges, strategy=strategy)
        if kind == "bin2d":
            got = b.bin(jnp.asarray(data, jnp.float32))[1]
            ref = _np_binned(data, ml, edges)
        else:
            w = rng.uniform(0.5, 2.0, geom.shape)
            got = b.bin(jnp.asarray(data, jnp.float32),
                        weights=jnp.asarray(w, jnp.float32))[1]
            ref = (_np_binned(data * w, ml, edges)
                   / _np_binned(w[None], ml, edges))
    np.testing.assert_allclose(np.asarray(got, np.float64), ref,
                               rtol=2e-5)


@pytest.mark.parametrize("strategy", ["rowcum", "triton"])
def test_nonradial_map_takes_segment_path(strategy):
    rng = np.random.default_rng(2)
    mod = rng.uniform(0, 10, (16, 24))
    edges = np.linspace(0, 10, 6)
    b = Bin2D(mod, edges, strategy=strategy)
    assert not b._rowcum and not b._use_rowcum
    data = rng.standard_normal((16, 24))
    np.testing.assert_allclose(np.asarray(b.bin(jnp.asarray(data))[1]),
                               _np_binned(data, mod, edges)[0], rtol=1e-6)


@pytest.mark.parametrize("nmaps,npix,nseg", [(3, 1000, 7), (20, 4099, 40),
                                             (64, 512, 100), (70, 300, 16)])
def test_bin_kernel_interpret_vs_bincount(nmaps, npix, nseg):
    """Partial tiles, partial map blocks, ids outside [0, nseg)."""
    rng = np.random.default_rng(nmaps)
    x = rng.standard_normal((nmaps, npix)).astype(np.float32)
    ids = rng.integers(-2, nseg + 3, npix).astype(np.int32)
    got = np.asarray(bin_sums(jnp.asarray(x), jnp.asarray(ids), nseg,
                              interpret=True), np.float64)
    ok = (ids >= 0) & (ids < nseg)
    ref = np.stack([np.bincount(ids[ok], weights=r[ok].astype(np.float64),
                                minlength=nseg) for r in x])
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-6 * np.abs(x).sum(axis=1).max())


def test_bin_kernel_leading_dims_and_exact_split():
    """(2, 3, npix) inputs keep their leading dims; values that need all
    24 fp32 mantissa bits survive the three-term bf16 split exactly."""
    rng = np.random.default_rng(9)
    x = (1.0 + rng.integers(0, 2 ** 23, (2, 3, 256)) * 2.0 ** -23
         ).astype(np.float32)
    ids = np.zeros(256, np.int32)
    ids[128:] = 1
    got = np.asarray(bin_sums(jnp.asarray(x), jnp.asarray(ids), 2,
                              interpret=True), np.float64)
    assert got.shape == (2, 3, 2)
    ref = np.stack([x[..., :128].astype(np.float64).sum(-1),
                    x[..., 128:].astype(np.float64).sum(-1)], axis=-1)
    np.testing.assert_allclose(got, ref, rtol=1e-7)


def test_default_strategy_by_platform(monkeypatch):
    monkeypatch.delenv("ORPHICS_TPU_BIN", raising=False)
    assert binning._default_strategy() == "rowcum"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert binning._default_strategy() == binning._GPU_STRATEGY
    monkeypatch.setenv("ORPHICS_TPU_BIN", "segment")
    assert Bin2D(np.ones((4, 4)), [0.0, 2.0]).strategy == "segment"


def test_triton_strategy_lowers_per_platform():
    """One binner: the kernel in a CUDA lowering, the plain path in a CPU
    one (a CPU-placed pipeline on a GPU host)."""
    geom = _geom((48, 80))
    b = RfftBin2D(geom, np.arange(100, 2600, 150.0), strategy="triton")
    x = jax.ShapeDtypeStruct((2,) + geom.shape[:1] + (41,), jnp.float32)
    cpu = jax.jit(b.sum).trace(x).lower(lowering_platforms=("cpu",))
    cuda = jax.jit(b.sum).trace(x).lower(lowering_platforms=("cuda",))
    assert "bin_sums" not in cpu.as_text()
    assert "bin_sums" in cuda.as_text()


def test_unknown_strategy_rejected(monkeypatch):
    monkeypatch.setenv("ORPHICS_TPU_BIN", "pallas")
    with pytest.raises(ValueError, match="unknown binning strategy"):
        Bin2D(np.ones((4, 4)), [0.0, 2.0])


# ---------------------------------------------------------------------------
# B-spline lens gather
# ---------------------------------------------------------------------------

def _np_bspline(x, order):
    """Centered cardinal B-spline of degree ``order`` (truncated-power
    formula, independent of the library's piecewise polynomials)."""
    n = order
    out = np.zeros_like(x)
    for k in range(n + 2):
        t = x + (n + 1) / 2.0 - k
        out += (-1) ** k * math.comb(n + 1, k) * np.where(t > 0, t, 0) ** n
    return out / math.factorial(n)


def _np_lens(imap, alpha, geom, order):
    ny, nx = imap.shape
    w = 2 * np.pi * np.fft.fftfreq(ny)
    resp_y = sum(_np_bspline(np.array([float(j)]), order)[0]
                 * np.cos(j * w) for j in range(-3, 4))
    w = 2 * np.pi * np.fft.fftfreq(nx)
    resp_x = sum(_np_bspline(np.array([float(j)]), order)[0]
                 * np.cos(j * w) for j in range(-3, 4))
    c = np.fft.ifft2(np.fft.fft2(imap) / np.outer(resp_y, resp_x)).real
    py = np.arange(ny)[:, None] + alpha[0] / geom.dy
    px = np.arange(nx)[None, :] + alpha[1] / geom.dx
    y0, x0 = np.floor(py).astype(int), np.floor(px).astype(int)
    out = np.zeros_like(imap)
    for i in range(-3, 5):
        for j in range(-3, 5):
            wy = _np_bspline(py - (y0 + i), order)
            wx = _np_bspline(px - (x0 + j), order)
            out += wy * wx * c[(y0 + i) % ny, (x0 + j) % nx]
    return out


@pytest.mark.parametrize("order", [3, 5])
@pytest.mark.parametrize("shape", [(32, 32), (24, 40)])
def test_lens_gather_vs_numpy_spline(order, shape):
    from orphics_tpu.models import lensing
    geom = _geom(shape, px=2.0)
    rng = np.random.default_rng(order)
    imap = rng.standard_normal(shape)
    alpha = rng.uniform(-3, 3, (2,) + shape) * geom.dy
    got = np.asarray(lensing.lens_map_spline(jnp.asarray(imap),
                                             jnp.asarray(alpha), geom,
                                             order=order))
    ref = _np_lens(imap, alpha, geom, order)
    # the library's prefilter response is float32
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# Fused ILC coadds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 64), (48, 80)])
@pytest.mark.parametrize("kind", ["cilc", "silc", "kspace"])
def test_fused_ilc_vs_unfused(shape, kind):
    from orphics_tpu.models import ilc
    geom = _geom(shape)
    ml = geom.modlmap_np()
    nf, nco = 3, 2
    rng = np.random.default_rng(4)
    ells = np.arange(2, 8000)
    cov1d = rng.standard_normal((nf, nf, len(ells)))
    cov1d = (np.einsum("ik...,jk...->ij...", cov1d, cov1d)
             + 5 * np.eye(nf)[:, :, None])
    cinv1d = np.moveaxis(np.linalg.inv(np.moveaxis(cov1d, (0, 1),
                                                   (-2, -1))), (-2, -1),
                         (0, 1))
    cinv = np.stack([[np.interp(ml, ells, cinv1d[i, j], left=0, right=0)
                      for j in range(nf)] for i in range(nf)])
    maps = rng.standard_normal((nco, nf) + shape).astype(np.float32)
    kmaps = np.fft.fft2(maps.astype(np.float64))
    a = np.ones(nf)
    b = np.array([1.0, -2.0, 0.5])
    if kind == "cilc":
        got = ilc.cilc_coadd_fused(maps, cinv, a, b)
        k = np.stack([np.asarray(ilc.cilc(jnp.asarray(km), jnp.asarray(cinv),
                                          jnp.asarray(a), jnp.asarray(b)))
                      for km in kmaps])
    elif kind == "silc":
        got = ilc.silc_coadd_fused(maps, cinv)
        k = np.stack([np.asarray(ilc.silc(jnp.asarray(km),
                                          jnp.asarray(cinv)))
                      for km in kmaps])
    else:
        kb = np.stack([np.exp(-ml ** 2 * (i + 1) * 1e-7) for i in range(nf)])
        nc = np.stack([np.full(shape, 1.0 + i) for i in range(nf)])
        got = ilc.kspace_coadd_fused(maps, kb, nc)
        k = (kmaps * kb / nc).sum(1) / (kb ** 2 / nc).sum(0)
    ref = np.fft.ifft2(k).real
    np.testing.assert_allclose(np.asarray(got, np.float64), ref,
                               atol=2e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# LensedQEPipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 64), (48, 80)])
def test_lenspipe_order5_matches_unfused(shape):
    """LensedQEPipeline.step at lens_order 5 == the pipeline assembled
    from the unfused pieces (lens_map_spline with its own prefilter,
    the full-plane kappa_from_map QE and full-plane Bin2D)."""
    from orphics_tpu.models import lenspipe, lensing, theory, grf
    from orphics_tpu.ops import fourier as F
    geom = _geom(shape, px=3.0)
    th = theory.default_theory()
    pipe = lenspipe.LensedQEPipeline(geom, th, beam_arcmin=2.0,
                                     noise_uk_arcmin=5.0, klmax=2000,
                                     lens_order=5)
    key = jax.random.PRNGKey(4)
    got = np.asarray(pipe.step(key, 2))
    ells = np.arange(th.lpad + 1)
    csq_tt = grf.covsqrt_half(geom, ells, np.asarray(th.uCl("TT", ells)))
    nxr = shape[1] // 2 + 1
    full_binner = Bin2D(geom.modlmap_np(), pipe.binner.bin_edges)
    n0 = np.asarray(pipe.qe.N_L_kk("TT"))
    rows = []
    for keys in jax.random.split(key, (2, 3)):
        eta = [grf.rand_hermitian_half(k, geom) for k in keys]
        unlensed = F.irfft2(csq_tt * eta[0], geom)
        kin_h = pipe.csq_kk * eta[1]
        alpha = F.irfft2(pipe.alpha_filt * kin_h[None], geom)
        lensed = lensing.lens_map_spline(unlensed, alpha, geom, order=5)
        kobs = jnp.fft.rfft2(lensed) * pipe.kbeam_h + pipe.ncov_h * eta[2]
        xmap = jnp.fft.irfft2(kobs * pipe.inv_beam_h, s=shape)
        fk = pipe.qe.kappa_from_map("TT", jnp.fft.fft2(xmap))
        kin = jnp.fft.fft2(jnp.fft.irfft2(kin_h, s=shape))
        spectra = [(fk.conj() * kin).real * pipe.norm,
                   (kin.conj() * kin).real * pipe.norm,
                   (fk.conj() * fk).real * pipe.norm - n0]
        rows.append(np.stack([np.asarray(full_binner.bin(s)[1])
                              for s in spectra]))
        assert nxr == pipe.n0_h.shape[-1]
    ref = np.stack(rows)
    scale = np.abs(ref).max(axis=(0, 2), keepdims=True)
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-4)


# ---------------------------------------------------------------------------
# chip_smoke.py phases at tiny sizes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def test_smoke_require_gpu_exits_on_cpu(smoke, capsys):
    with pytest.raises(SystemExit) as e:
        smoke.require_gpu()
    assert e.value.code != 0
    assert "no GPU" in capsys.readouterr().err


def test_smoke_main_prints_no_result_on_cpu(smoke, capsys):
    with pytest.raises(SystemExit) as e:
        smoke.main([])
    assert e.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_phase_flat_tiny(smoke, monkeypatch):
    # the CPU's rowcum strategy carries row-cumsum cancellation error
    # above the 2e-6 limit the GPU kernel meets; check segment here
    monkeypatch.setenv("ORPHICS_TPU_BIN", "segment")
    out = smoke.phase_flat(n=96, px=4.0, nmaps=3, nbin_maps=5, nsims=8,
                           lrange=(300.0, 2000.0))
    assert out["map_bp"] <= 1e-5 and out["bin"] <= 2e-6


def test_smoke_phase_lensing_tiny(smoke):
    out = smoke.phase_lensing(n=64, px=8.0, batch=8, cmp_batch=2)
    assert out["device_vs_cpu"] <= 1e-4 and out["ratio_excess"] < 0


def test_smoke_phase_curved_tiny(smoke):
    out = smoke.phase_curved(lmax=63, lmax_spin=31, lmax_mc=255,
                             mc_batch=2)
    assert out["rt0"] <= 1e-5 and out["rt2"] <= 1e-5


def test_smoke_phase_multi_on_cpu_devices(smoke):
    out = smoke.phase_multi(ndev=4, nsims=4, n_fft=128, lmax=63)
    assert out["fft2"] <= 1e-5 and out["map2alm"] <= 1.5e-4


def test_smoke_check_raises(smoke):
    with pytest.raises(smoke.CheckFailed):
        smoke.check("x", 2.0, 1.0, False)


def test_qe_n0_float32_matches_float64():
    """The float32 N_L^0 agrees with float64 inside the kappa mask. A_L^2
    is ~1e-40 at L ~ 3000, below float32's normal range: forming it first
    zeroed (or, on a CPU, denormalised) N0 there."""
    from orphics_tpu.models import lenspipe, theory
    geom = rect_geometry(width_arcmin=512 * 2.0, px_res_arcmin=2.0)
    th = theory.default_theory()
    n0 = {}
    for dt in (jnp.float32, jnp.float64):
        pipe = lenspipe.LensedQEPipeline(geom, th, lens_order=3, dtype=dt)
        n0[dt] = np.asarray(pipe.n0_h, np.float64)
        kmask = np.asarray(pipe.qe.kmask)[:, :geom.nx // 2 + 1] > 0
    rel = np.abs(n0[jnp.float32] - n0[jnp.float64])[kmask] / np.abs(
        n0[jnp.float64][kmask])
    assert rel.max() < 1e-3, rel.max()
