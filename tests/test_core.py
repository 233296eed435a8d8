"""Core-slice tests: geometry, Fourier calculus, binning, GRF synthesis.

Validation strategy per SURVEY §4: closed-form identities and independent
numpy re-derivations of the reference's documented conventions (digitize +
bincount binning, area/npix^2 power normalization), plus Monte-Carlo
input-recovery of binned GRF power (the ``demo-grf.ipynb`` pattern).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from orphics_tpu import rect_geometry, Geometry
from orphics_tpu.ops import fourier as F
from orphics_tpu.ops.binning import Bin2D
from orphics_tpu.models import grf, theory
from orphics_tpu import maps


@pytest.fixture(scope="module")
def geom():
    return rect_geometry(width_deg=10.0, px_res_arcmin=2.0)


@pytest.fixture(scope="module")
def th():
    return theory.default_theory()


def test_geometry_basics(geom):
    assert geom.shape == (300, 300)
    np.testing.assert_allclose(geom.area, geom.npix * geom.pixsize)
    ml = np.asarray(geom.modlmap())
    # DC mode at [0,0]; symmetry of |l| grid under reflection
    assert ml[0, 0] == 0.0
    np.testing.assert_allclose(ml[1:, 1:], ml[1:, 1:][::-1, ::-1], rtol=1e-5)
    # matches direct fftfreq computation
    ly = 2 * np.pi * np.fft.fftfreq(geom.ny, geom.dy)
    lx = 2 * np.pi * np.fft.fftfreq(geom.nx, geom.dx)
    expect = np.sqrt(ly[:, None] ** 2 + lx[None, :] ** 2)
    np.testing.assert_allclose(ml, expect, rtol=2e-6)


def test_fft_roundtrip_and_parseval(geom):
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, geom.shape)
    k = F.fft2(x, geom, "ortho")
    back = F.ifft2(k, geom, "ortho").real
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=1e-4)
    # Parseval under ortho norm
    np.testing.assert_allclose(float(jnp.sum(jnp.abs(k) ** 2)),
                               float(jnp.sum(x ** 2)), rtol=1e-5)


def test_f2power_matches_numpy_convention(geom):
    """P2d = Re(conj(F1) F2) * area/npix^2 with raw numpy FFTs
    (reference orphics/maps.py:1620-1624)."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal(geom.shape).astype(np.float32)
    b = rng.standard_normal(geom.shape).astype(np.float32)
    ka, kb = np.fft.fft2(a), np.fft.fft2(b)
    expect = np.real(np.conj(ka) * kb) * geom.area / geom.npix ** 2
    got = np.asarray(F.f2power(F.fft2(jnp.asarray(a), geom),
                               F.fft2(jnp.asarray(b), geom), geom))
    np.testing.assert_allclose(got, expect, rtol=2e-4, atol=1e-10)


def test_queb_rotation_roundtrip(geom):
    key = jax.random.PRNGKey(2)
    kmaps = (jax.random.normal(key, (3,) + geom.shape)
             + 1j * jax.random.normal(jax.random.PRNGKey(3), (3,) + geom.shape))
    teb = F.iqu2teb(kmaps, geom)
    back = F.teb2iqu(teb, geom)
    np.testing.assert_allclose(np.asarray(back), np.asarray(kmaps), atol=1e-4)


def test_bin2d_matches_reference_algorithm(geom):
    """Independent numpy digitize+bincount re-derivation
    (reference orphics/stats.py:786-797)."""
    rng = np.random.default_rng(4)
    data = rng.standard_normal(geom.shape).astype(np.float32)
    modlmap = geom.modlmap_np()
    edges = np.arange(80, 4000, 80.0)
    binner = Bin2D(modlmap, edges)
    cents, res = binner.bin(jnp.asarray(data))
    dig = np.digitize(modlmap.reshape(-1), edges, right=True)
    count = np.bincount(dig)[1:-1]
    expect = np.bincount(dig, data.reshape(-1))[1:-1] / count
    np.testing.assert_allclose(np.asarray(res), expect, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(cents, (edges[1:] + edges[:-1]) / 2)
    np.testing.assert_array_equal(binner.counts, count)


def test_bin2d_batched(geom):
    rng = np.random.default_rng(5)
    data = rng.standard_normal((4,) + geom.shape).astype(np.float32)
    edges = np.arange(80, 4000, 160.0)
    binner = Bin2D(np.asarray(geom.modlmap()), edges)
    _, res = binner.bin(jnp.asarray(data))
    for i in range(4):
        _, ri = binner.bin(jnp.asarray(data[i]))
        np.testing.assert_allclose(np.asarray(res[i]), np.asarray(ri), rtol=1e-6)


def test_theory_tables(th):
    """Spot-check the CAMB loader against the raw file values."""
    import os
    fn = os.path.join(theory.DATA_DIR, "cosmo2017_10K_acc3_lensedCls.dat")
    raw = np.loadtxt(fn)
    l = raw[10, 0]
    cltt_expected = raw[10, 1] * 2 * np.pi / l / (l + 1)
    got = float(th.lCl("TT", l))
    np.testing.assert_allclose(got, cltt_expected, rtol=1e-5)
    # clkk from lenspotential column 5
    fn2 = os.path.join(theory.DATA_DIR, "cosmo2017_10K_acc3_lenspotentialCls.dat")
    raw2 = np.loadtxt(fn2)
    clkk_expected = raw2[100, 5] * 2 * np.pi / 4.0
    np.testing.assert_allclose(float(th.gCl("kk", raw2[100, 0])), clkk_expected,
                               rtol=1e-5)
    # zero fill beyond lpad
    assert float(th.lCl("TT", 9500)) == 0.0
    assert float(th.lCl("TT", 0)) == 0.0


def test_grf_recovers_input_power(geom, th):
    """Monte-Carlo: mean binned power of GRF sims recovers input Cl
    (demo-grf.ipynb pattern). Knox errors set the tolerance."""
    lmax = 5000
    ells = np.arange(lmax + 1)
    cltt = np.asarray(th.lCl("TT", ells))
    mgen = grf.MapGen(geom, cltt[None, None, :])
    edges = np.arange(200, 3000, 200.0)
    binner = Bin2D(geom.modlmap_np(), edges)
    fc = maps.FourierCalc(geom)

    @jax.jit
    def pipe(key):
        imap = mgen.get_map(key)
        p2d, _, _ = fc.power2d(imap)
        _, p1d = binner.bin(p2d)
        return p1d

    nsims = 48
    keys = jax.random.split(jax.random.PRNGKey(7), nsims)
    p1ds = np.asarray(jax.vmap(pipe)(keys))
    mean = p1ds.mean(axis=0)
    err = p1ds.std(axis=0, ddof=1) / np.sqrt(nsims)
    cents, th_binned = binner.bin(jnp.asarray(F.interp1d_to_2d(
        ells, cltt, geom, dtype=jnp.float64)))
    th_binned = np.asarray(th_binned)
    nsig = np.abs(mean - th_binned) / err
    # every bin within 5 sigma and the mean ratio within 2%
    assert np.all(nsig < 5.0), nsig
    ratio = mean / th_binned
    assert abs(ratio.mean() - 1) < 0.02, ratio


def test_grf_pol_te_cross(geom, th):
    """TE cross-spectrum of polarized GRF sims recovers input (sign and
    correlation conventions)."""
    ps = grf.cmb_ps(th, lmax=5000)
    mgen = grf.MapGen(geom, ps)
    edges = np.arange(300, 2500, 300.0)
    binner = Bin2D(geom.modlmap_np(), edges)
    fc = maps.FourierCalc(geom)

    @jax.jit
    def pipe(key):
        imap = mgen.get_map(key)  # (3, ny, nx) I,Q,U
        p2d, _, _ = fc.power2d(imap)  # (3,3,ny,nx) TEB
        _, te = binner.bin(p2d[0, 1])
        _, ee = binner.bin(p2d[1, 1])
        _, bb = binner.bin(p2d[2, 2])
        return te, ee, bb

    nsims = 48
    keys = jax.random.split(jax.random.PRNGKey(11), nsims)
    te, ee, bb = jax.vmap(pipe)(keys)
    te, ee, bb = (np.asarray(v) for v in (te, ee, bb))
    ells = np.arange(5001)
    for spec, mc in (("TE", te), ("EE", ee), ("BB", bb)):
        cl = np.asarray(th.lCl(spec, ells))
        _, thb = binner.bin(jnp.asarray(F.interp1d_to_2d(ells, cl, geom,
                                                         dtype=jnp.float64)))
        thb = np.asarray(thb)
        err = mc.std(axis=0, ddof=1) / np.sqrt(nsims)
        nsig = np.abs(mc.mean(axis=0) - thb) / err
        assert np.all(nsig < 5.0), (spec, nsig)


def test_binned_power_mask_w2(geom, th):
    """w2 correction restores power under an apodized-ish mask."""
    ells = np.arange(5001)
    cltt = np.asarray(th.lCl("TT", ells))
    mgen = grf.MapGen(geom, cltt[None, None, :])
    # smooth mask
    x = np.asarray(geom.modrmap())
    mask = jnp.asarray(0.5 * (1 + np.cos(np.pi * np.clip(x / x.max(), 0, 1))))
    edges = np.arange(500, 2500, 250.0)
    binner = Bin2D(geom.modlmap_np(), edges)
    fc = maps.FourierCalc(geom)

    @jax.jit
    def pipe(key):
        imap = mgen.get_map(key)
        _, p1d = maps.binned_power(imap, binner=binner, mask=mask, fc=fc)
        return p1d

    nsims = 64
    keys = jax.random.split(jax.random.PRNGKey(13), nsims)
    p1ds = np.asarray(jax.vmap(pipe)(keys))
    _, thb = binner.bin(jnp.asarray(F.interp1d_to_2d(ells, cltt, geom,
                                                     dtype=jnp.float64)))
    ratio = p1ds.mean(axis=0) / np.asarray(thb)
    # mode-coupling smears bins; the mean level must be right to a few %
    assert abs(ratio.mean() - 1) < 0.05, ratio


def test_rfft_binner_matches_full_plane(geom, th):
    """Half-plane binning with multiplicity weights == full-plane binning,
    exactly, for the power of a real map."""
    from orphics_tpu.ops.binning import RfftBin2D
    rng = np.random.default_rng(21)
    imap = rng.standard_normal(geom.shape).astype(np.float32)
    edges = np.arange(80, 4000, 160.0)
    bfull = Bin2D(geom.modlmap_np(), edges)
    bhalf = RfftBin2D(geom, edges, strategy="rowcum")
    pfull = np.abs(np.fft.fft2(imap)) ** 2 * geom.area / geom.npix ** 2
    phalf = np.abs(np.fft.rfft2(imap)) ** 2 * geom.area / geom.npix ** 2
    _, r1 = bfull.bin(jnp.asarray(pfull))
    _, r2 = bhalf.bin(jnp.asarray(phalf.astype(np.float64)))
    np.testing.assert_allclose(np.asarray(r2), np.asarray(r1), rtol=1e-5)


def test_rfft_binner_edge_collision_f64(geom):
    """RfftBin2D digitizes the host-float64 |l| grid bit-identically to
    np.digitize on the f64 rfft half-plane — including pixels whose |l|
    sits exactly on a bin edge, where an fp32-truncated grid (the old
    ``geom.modlmap(jnp.float64)`` device path, silently fp32 under
    x64-off) moves pixels across the edge."""
    from orphics_tpu.ops.binning import RfftBin2D
    half64 = geom.modlmap_r_np()                       # host f64, exact
    half32 = half64.astype(np.float32).astype(np.float64)
    # Pick edges that land EXACTLY on grid |l| values whose fp32 rounding
    # moves them across the edge (collision pixels).
    moved_up = (half32 > half64) & (half64 > 0)
    assert moved_up.any(), "geometry has no fp32-rounds-up |l| values"
    vals = np.unique(half64[moved_up])
    edges = np.sort(np.concatenate([[vals[0] - 1.0], vals[:6],
                                    [vals[:6].max() + 50.0]]))
    b = RfftBin2D(geom, edges)
    want = np.digitize(half64.reshape(-1), edges, right=True)
    got = np.asarray(b._dig_dev)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    # teeth: the fp32 grid really would disagree on the collision pixels
    wrong = np.digitize(half32.reshape(-1), edges, right=True)
    assert (wrong != want).any()


def test_binner_construction_emits_no_truncation_warnings(geom):
    """Constructing the bench-path binners must not request device float64
    (jax warns + truncates under x64-off); guards the 'warning-free bench'
    claim."""
    import warnings
    from orphics_tpu.ops.binning import RfftBin2D
    edges = np.arange(80, 4000, 160.0)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        RfftBin2D(geom, edges)
        Bin2D(geom.modlmap_np(), edges)
        Bin2D(geom.modrmap_np(), np.linspace(0, 0.05, 16))
    bad = [str(w.message) for w in rec
           if "float64" in str(w.message)
           and "truncat" in str(w.message).lower()]
    assert not bad, bad


def test_fastcl_map_bandpowers(th):
    """FastCl.map_bandpowers (rfft2 half-plane pipeline) matches the
    FourierCalc-style fft2 -> f2power -> Bin2D reference for an odd
    batch."""
    from orphics_tpu.models.fastcl import FastCl
    from orphics_tpu.ops import fourier as F
    n = 256
    geom = rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    edges = np.arange(80, 4000, 160.0)
    fc = FastCl(geom, bin_edges=edges)
    rng = np.random.default_rng(4)
    maps = rng.standard_normal((3, n, n)).astype(np.float32)
    got = np.asarray(fc.map_bandpowers(maps))
    binner = Bin2D(geom.modlmap_np(), edges,
                   strategy="rowcum")
    ref = []
    for m in maps:
        k = F.fft2(jnp.asarray(m, jnp.float64), geom, "raw")
        ref.append(np.asarray(binner.bin(F.f2power(k, k, geom))[1]))
    np.testing.assert_allclose(got, np.stack(ref), rtol=2e-5, atol=1e-8)


def test_fastcl_cross_bandpowers(th):
    """FastCl.cross_bandpowers (Re(x conj y) on the half plane) matches
    the f2power(k1, k2) + Bin2D reference."""
    from orphics_tpu.models.fastcl import FastCl
    from orphics_tpu.ops import fourier as F
    n = 256
    geom = rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    edges = np.arange(80, 4000, 160.0)
    fc = FastCl(geom, bin_edges=edges)
    rng = np.random.default_rng(8)
    m1 = rng.standard_normal((2, n, n)).astype(np.float32)
    m2 = rng.standard_normal((2, n, n)).astype(np.float32)
    got = np.asarray(fc.cross_bandpowers(m1, m2))
    binner = Bin2D(geom.modlmap_np(), edges,
                   strategy="rowcum")
    ref = []
    for a, b in zip(m1, m2):
        k1 = F.fft2(jnp.asarray(a, jnp.float64), geom, "raw")
        k2 = F.fft2(jnp.asarray(b, jnp.float64), geom, "raw")
        ref.append(np.asarray(binner.bin(F.f2power(k1, k2, geom))[1]))
    np.testing.assert_allclose(got, np.stack(ref), rtol=3e-5, atol=1e-7)


def test_rand_map_r_statistics(geom, th):
    """The half-plane irfft synthesis route recovers the input spectrum
    (statistically identical to the full-plane route)."""
    from orphics_tpu.ops.binning import RfftBin2D
    ells = np.arange(5001)
    cltt = np.asarray(th.lCl("TT", ells))
    ch = grf.covsqrt_half(geom, ells, cltt, dtype=jnp.float64)
    edges = np.arange(300, 2500, 200.0)
    binner = RfftBin2D(geom, edges, strategy="rowcum")
    norm = geom.area / geom.npix ** 2

    @jax.jit
    def pipe(key):
        imap = grf.rand_map_r(key, geom, ch, dtype=jnp.float64)
        k = jnp.fft.rfft2(imap)
        p = (k.conj() * k).real * norm
        return binner.bin(p)[1]

    nsims = 48
    p1ds = np.asarray(jax.vmap(pipe)(jax.random.split(jax.random.PRNGKey(31), nsims)))
    _, thb = binner.bin(jnp.asarray(np.interp(
        geom.modlmap_np()[:, :geom.nx // 2 + 1], ells, cltt)))
    thb = np.asarray(thb)
    err = p1ds.std(axis=0, ddof=1) / np.sqrt(nsims)
    nsig = np.abs(p1ds.mean(axis=0) - thb) / err
    assert np.all(nsig < 5.0), nsig
    assert abs((p1ds.mean(axis=0) / thb).mean() - 1) < 0.02


def test_fastcl_cross_window_fused():
    """cross_bandpowers(window=w) must match pre-multiplied maps."""
    from orphics_tpu import rect_geometry
    from orphics_tpu.models.fastcl import FastCl
    from orphics_tpu.ops.windows import get_taper
    rng = np.random.default_rng(8)
    n = 256
    geom = rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    edges = np.arange(100, 2500, 150.0)
    fc = FastCl(geom, bin_edges=edges)
    taper, _w2 = get_taper(geom, taper_percent=12.0)
    taper = jnp.asarray(np.asarray(taper), jnp.float32)
    m1 = jnp.asarray(rng.standard_normal((2, n, n)).astype(np.float32))
    m2 = jnp.asarray(rng.standard_normal((2, n, n)).astype(np.float32))
    a = np.asarray(fc.cross_bandpowers(m1, m2, window=taper))
    b = np.asarray(fc.cross_bandpowers(m1 * taper, m2 * taper))
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-8)


def test_cilc_coadd_fused_library_api():
    """ilc.cilc_coadd_fused (band maps -> coadd maps on the rfft half
    plane) matches ifft2(cilc(fft2(maps))).real for an isotropic
    (mirror-symmetric) 2D inverse covariance."""
    from orphics_tpu.models import ilc
    rng = np.random.default_rng(1)
    n, nf, nco = 256, 4, 2
    g = rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    ml = g.modlmap_np()
    ells = np.arange(2, 6000)
    cov1d = rng.standard_normal((nf, nf, len(ells)))
    cov1d = np.einsum("ik...,jk...->ij...", cov1d, cov1d) \
        + 5 * np.eye(nf)[:, :, None]
    cinv1d = np.moveaxis(np.linalg.inv(
        np.moveaxis(cov1d, (0, 1), (-2, -1))), (-2, -1), (0, 1))
    cinv = np.stack([[np.interp(ml, ells, cinv1d[i, j], left=0, right=0)
                      for j in range(nf)]
                     for i in range(nf)]).astype(np.float32)
    a = np.ones(nf, np.float32)
    b = np.asarray([1.0, -2.0, 0.5, 3.0], np.float32)
    maps_in = rng.standard_normal((nco, nf, n, n)).astype(np.float32)
    from orphics_tpu.models.ilc import cilc
    ref = np.stack([np.fft.ifft2(np.asarray(cilc(
        jnp.asarray(np.fft.fft2(maps_in[j])), jnp.asarray(cinv),
        jnp.asarray(a), jnp.asarray(b)))).real for j in range(nco)])
    got = np.asarray(ilc.cilc_coadd_fused(maps_in, cinv, a, b))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def test_linear_coadd_fused_variants():
    """silc_coadd_fused and kspace_coadd_fused (the generic
    linear_coadd_fused primitive) match the explicit k-space formulas."""
    from orphics_tpu.models import ilc
    rng = np.random.default_rng(1)
    n, nf, nco = 256, 4, 2
    g = rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    ml = g.modlmap_np()
    ells = np.arange(2, 6000)
    cov1d = rng.standard_normal((nf, nf, len(ells)))
    cov1d = np.einsum("ik...,jk...->ij...", cov1d, cov1d) \
        + 5 * np.eye(nf)[:, :, None]
    cinv1d = np.moveaxis(np.linalg.inv(
        np.moveaxis(cov1d, (0, 1), (-2, -1))), (-2, -1), (0, 1))
    cinv = np.stack([[np.interp(ml, ells, cinv1d[i, j], left=0, right=0)
                      for j in range(nf)]
                     for i in range(nf)]).astype(np.float32)
    maps_in = rng.standard_normal((nco, nf, n, n)).astype(np.float32)
    # silc
    refs = np.stack([np.fft.ifft2(np.asarray(ilc.silc(
        jnp.asarray(np.fft.fft2(maps_in[j])), jnp.asarray(cinv)))).real
        for j in range(nco)])
    gots = np.asarray(ilc.silc_coadd_fused(maps_in, cinv))
    assert np.abs(gots - refs).max() / np.abs(refs).max() < 1e-5
    # kspace coadd
    kb2d = np.stack([np.full((n, n), 0.5 + i) for i in range(nf)])
    nc2d = np.stack([np.full((n, n), 1.0 + i) for i in range(nf)])
    refk = []
    for j in range(nco):
        km = np.fft.fft2(maps_in[j])
        num = (km * kb2d / nc2d).sum(0)
        den = (kb2d ** 2 / nc2d).sum(0)
        refk.append(np.fft.ifft2(num / den).real)
    refk = np.stack(refk)
    gotk = np.asarray(ilc.kspace_coadd_fused(maps_in, kb2d, nc2d))
    assert np.abs(gotk - refk).max() / np.abs(refk).max() < 1e-5


class TestSynthesisRegressions:
    """Review regressions for grf/fourier/fastcl."""

    def test_mask_kspace_strict_boundaries(self):
        """Reference semantics (maps.py:1936): modes exactly AT lmin or
        lmax are cut (in particular lmin=0 removes DC); the old
        inclusive keep retained them."""
        geom = rect_geometry(width_arcmin=64 * 8.0, px_res_arcmin=8.0)
        m = np.asarray(F.mask_kspace(geom, lmin=0))
        assert m[0, 0] == 0.0                      # DC removed
        ml = geom.modlmap_np()
        lmax_val = float(ml[0, 5])                 # an exact grid mode
        m2 = np.asarray(F.mask_kspace(geom, lmax=lmax_val))
        assert m2[0, 5] == 0.0

    def test_iqu2teb_two_component(self):
        """A (2, ny, nx) Q/U stack rotates to E/B (reference rotates
        the last two components for any ncomp > 1; the old ==3 gate
        silently returned QU labeled EB)."""
        geom = rect_geometry(width_arcmin=64 * 8.0, px_res_arcmin=8.0)
        key = jax.random.PRNGKey(0)
        iqu = jax.random.normal(key, (3,) + geom.shape)
        k3 = F.iqu2teb(F.fft2(iqu, geom, "raw"), geom)
        k2 = F.iqu2teb(F.fft2(iqu[1:], geom, "raw"), geom)
        np.testing.assert_allclose(np.asarray(k2), np.asarray(k3[1:]),
                                   rtol=1e-6)

    def test_white_noise_pixsizemap(self):
        """white_noise defaults to the per-pixel solid angle incl.
        cos(dec): at dec 60 deg the per-pixel sigma is 1/sqrt(cos 60)
        = sqrt(2) larger than at the equator."""
        from orphics_tpu.models import grf
        g_eq = rect_geometry(width_arcmin=128 * 2.0, px_res_arcmin=2.0)
        g_60 = rect_geometry(width_arcmin=128 * 2.0, px_res_arcmin=2.0,
                             y0_deg=60.0)
        k = jax.random.PRNGKey(1)
        n_eq = np.asarray(grf.white_noise(k, g_eq, 10.0))
        n_60 = np.asarray(grf.white_noise(k, g_60, 10.0))
        ratio = n_60.std() / n_eq.std()
        assert abs(ratio - np.sqrt(2.0)) < 0.1, ratio

    def test_fastcl_nonzero_start_ells(self):
        """FastCl re-grids spectra whose ells start at 2 (CAMB tables)
        instead of silently shifting every multipole by the offset."""
        from orphics_tpu.models.fastcl import FastCl
        geom = rect_geometry(width_arcmin=256 * 2.0, px_res_arcmin=2.0)
        lmax = 8000
        dense = 1e3 / (np.arange(lmax + 1) + 100.0) ** 2
        dense[:2] = 0.0          # the ell>=2 table carries no l<2 power
        edges = np.arange(100, 3000, 200.0)
        fc_dense = FastCl(geom, np.arange(lmax + 1), dense,
                          bin_edges=edges)
        fc_cut = FastCl(geom, np.arange(2, lmax + 1), dense[2:],
                        bin_edges=edges)
        np.testing.assert_allclose(np.asarray(fc_cut._covsqrt_h),
                                   np.asarray(fc_dense._covsqrt_h),
                                   atol=1e-7)
        with pytest.raises(ValueError, match="bin_edges"):
            FastCl(geom)


def test_binner_construction_f64_edge_collisions():
    """Binner membership must be computed from the
    full-precision host |l| grid. Build edges that collide exactly with
    grid |l| values (where an fp32-truncated grid would digitize
    differently) and check Bin2D's counts equal a pure-f64 digitize."""
    from orphics_tpu.geometry import rect_geometry
    geom = rect_geometry(width_deg=6.0, px_res_arcmin=3.0)
    ml = geom.modlmap_np()
    assert ml.dtype == np.float64
    # edges exactly on |l| values present in the grid (collision points)
    vals = np.unique(ml.ravel())
    picks = vals[np.linspace(10, len(vals) - 2, 25).astype(int)]
    edges = np.unique(np.concatenate([picks, [0.0, vals[-1] * 1.1]]))
    binner = Bin2D(ml, edges)
    dig = np.digitize(ml.reshape(-1), edges, right=True)
    counts = np.bincount(dig, minlength=len(edges) + 1)[1:-1]
    np.testing.assert_array_equal(binner.counts, counts[:len(edges) - 1])
    # an fp32 grid digitizes differently at collisions — this pins that
    # the difference is real (i.e. the f64 path matters)
    dig32 = np.digitize(ml.astype(np.float32).reshape(-1), edges, right=True)
    assert (dig32 != dig).any()
