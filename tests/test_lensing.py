"""Lensing tests: kappa/phi calculus, map lensing operators, lensed sims,
and the quadratic-estimator Monte-Carlo validation (the
tt_verification.ipynb pattern, SURVEY §4)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from orphics_tpu import rect_geometry
from orphics_tpu.ops import fourier as F
from orphics_tpu.ops.binning import Bin2D
from orphics_tpu.models import grf, theory, lensing, qe


@pytest.fixture(scope="module")
def geom():
    # 128^2 at 3 arcmin: 6.4 deg patch, Nyquist ~ 3600
    return rect_geometry(width_arcmin=128 * 3.0, px_res_arcmin=3.0)


@pytest.fixture(scope="module")
def th():
    return theory.default_theory()


def test_kappa_phi_roundtrip(geom):
    rng = np.random.default_rng(0)
    kappa = jnp.asarray(rng.standard_normal(geom.shape))
    phi = lensing.kappa_to_phi(kappa, geom)
    # invert: kappa = l(l+1)/2 phi
    ml = geom.modlmap(jnp.float64)
    fphi = F.fft2(phi, geom, "phys")
    back = F.ifft2(0.5 * ml * (ml + 1) * fphi, geom, "phys").real
    # modes with l<2 were zeroed; compare after removing them from input
    fk = F.fft2(kappa, geom, "phys")
    kref = F.ifft2(jnp.where(ml < 2, 0, fk), geom, "phys").real
    np.testing.assert_allclose(np.asarray(back), np.asarray(kref),
                               atol=1e-5 * float(jnp.abs(kref).max()))


def test_lens_map_integer_shift(geom):
    """Constant deflection of an integer number of pixels == np.roll."""
    rng = np.random.default_rng(1)
    imap = jnp.asarray(rng.standard_normal(geom.shape).astype(np.float32))
    alpha = jnp.stack([jnp.full(geom.shape, 3 * geom.dy),
                       jnp.full(geom.shape, -2 * geom.dx)])
    for method in (lensing.lens_map_spline, lensing.taylens):
        out = method(imap, alpha, geom, order=3)
        expect = np.roll(np.asarray(imap), (-3, 2), axis=(0, 1))
        np.testing.assert_allclose(np.asarray(out), expect, atol=2e-4,
                                   err_msg=str(method))


def test_lens_map_plane_wave(geom):
    """Lensing a band-limited plane wave by a smooth deflection matches the
    analytic displaced wave."""
    ky_mode, kx_mode = 6, 9  # low-frequency wave, well below Nyquist
    y = np.arange(geom.ny) * geom.dy
    x = np.arange(geom.nx) * geom.dx
    yy, xx = np.meshgrid(y, x, indexing="ij")
    wy = 2 * np.pi * ky_mode / (geom.ny * geom.dy)
    wx = 2 * np.pi * kx_mode / (geom.nx * geom.dx)
    imap = jnp.asarray(np.cos(wy * yy + wx * xx).astype(np.float32))
    # smooth periodic deflection, sub-pixel amplitude
    ay = 0.4 * geom.dy * np.cos(2 * np.pi * yy / (geom.ny * geom.dy))
    ax = 0.3 * geom.dx * np.sin(2 * np.pi * xx / (geom.nx * geom.dx))
    alpha = jnp.asarray(np.stack([ay, ax]).astype(np.float32))
    expect = np.cos(wy * (yy + ay) + wx * (xx + ax))
    for order in (3, 5):
        out = np.asarray(lensing.lens_map_spline(imap, alpha, geom, order=order))
        err = np.abs(out - expect).max()
        assert err < (2e-3 if order == 3 else 5e-4), (order, err)
    out_t = np.asarray(lensing.taylens(imap, alpha, geom, order=5))
    assert np.abs(out_t - expect).max() < 1e-3


def test_lensed_sims_power(geom, th):
    """MC: lensed sims (unlensed + GRF kappa -> displace) reproduce the
    *lensed* theory spectrum better than the unlensed one."""
    fls = lensing.FlatLensingSims(geom, th, beam_arcmin=0.0,
                                  noise_uk_arcmin=0.0, lens_order=5)
    edges = np.arange(400, 3000, 200.0)
    binner = Bin2D(geom.modlmap_np(), edges)
    norm = geom.area / geom.npix ** 2

    @jax.jit
    def pipe(key):
        kc, kk = jax.random.split(key)
        unlensed = fls.get_unlensed(kc)
        kappa = fls.get_kappa(kk)
        lensed = fls.lens(unlensed, kappa)
        k = jnp.fft.fft2(lensed)
        p2d = (k.conj() * k).real * norm
        return binner.bin(p2d)[1]

    nsims = 96
    keys = jax.random.split(jax.random.PRNGKey(5), nsims)
    p1ds = np.asarray(jax.vmap(pipe)(keys))
    mean = p1ds.mean(axis=0)
    err = p1ds.std(axis=0, ddof=1) / np.sqrt(nsims)
    ells = np.arange(th.lpad + 1)
    ml = jnp.asarray(geom.modlmap_np())
    lcl = np.asarray(binner.bin(jnp.asarray(np.interp(
        np.asarray(ml), ells, np.asarray(th.lCl("TT", ells)))))[1])
    ucl = np.asarray(binner.bin(jnp.asarray(np.interp(
        np.asarray(ml), ells, np.asarray(th.uCl("TT", ells)))))[1])
    # interpolation lensing mildly low-passes the last ~20% below Nyquist
    # (the reference's displace_map shares this property): validate the
    # well-resolved range strictly, the tail loosely.
    res = binner.centers < 2300
    chi2_l = np.sum((mean - lcl)[res] ** 2 / err[res] ** 2)
    chi2_u = np.sum((mean - ucl)[res] ** 2 / err[res] ** 2)
    assert chi2_l < 0.2 * chi2_u, (chi2_l, chi2_u)
    assert chi2_l / res.sum() < 3.0, (chi2_l / res.sum(), mean / lcl)
    ratio = mean / lcl
    assert np.all(np.abs(ratio[res] - 1) < 0.02), ratio
    assert np.all(np.abs(ratio[~res] - 1) < 0.06), ratio


@pytest.mark.parametrize("est", ["TT", "EB", "EE", "TE"])
def test_qe_cross_ratio(geom, th, est):
    """tt_verification pattern: <C(kappa_hat, kappa_in)> / <C(kappa_in,
    kappa_in)> consistent with 1."""
    beam, noise = 1.5, 1.0
    pol = est != "TT"
    fls = lensing.FlatLensingSims(geom, th, beam_arcmin=beam,
                                  noise_uk_arcmin=noise, pol=pol, lens_order=5)
    ctot = qe.lensing_noise_2d(geom, th, beam, noise)
    xmask = F.mask_kspace(geom, lmin=100, lmax=3000)
    kmask = F.mask_kspace(geom, lmin=40, lmax=500)
    q = qe.QE(geom, th, ctot, xmask=xmask, kmask=kmask, dtype=jnp.float64)
    edges = np.arange(60, 480, 80.0)
    binner = Bin2D(geom.modlmap_np(), edges)
    kbeam = F.gauss_beam(geom.modlmap(jnp.float64), beam)
    norm = geom.area / geom.npix ** 2

    @jax.jit
    def pipe(key):
        kc, kk, kn = jax.random.split(key, 3)
        unlensed = fls.get_unlensed(kc)
        kappa = fls.get_kappa(kk)
        lensed = fls.lens(unlensed, kappa)
        beamed = F.kfilter(lensed, fls.kbeam, geom)
        observed = beamed + fls.ngen.get_map(kn)
        kobs = jnp.fft.fft2(observed) / jnp.maximum(kbeam, 1e-8)
        if pol:
            kteb = F.iqu2teb(kobs, geom)
            if est == "EB":
                fkrec = q.kappa_from_map("EB", kteb[1], kteb[2])
            elif est == "EE":
                fkrec = q.kappa_from_map("EE", kteb[1], kteb[1])
            elif est == "TE":
                fkrec = q.kappa_from_map("TE", kteb[0], kteb[1])
        else:
            fkrec = q.kappa_from_map("TT", kobs)
        fk_in = jnp.fft.fft2(kappa)
        cross = (fkrec.conj() * fk_in).real * norm
        auto = (fk_in.conj() * fk_in).real * norm
        return binner.bin(cross)[1], binner.bin(auto)[1]

    nsims = 48
    keys = jax.random.split(jax.random.PRNGKey(7), nsims)
    cross, auto = jax.vmap(pipe)(keys)
    cross, auto = np.asarray(cross), np.asarray(auto)
    ratio = cross.mean(axis=0) / auto.mean(axis=0)
    ratio_err = (cross.std(axis=0, ddof=1) / np.sqrt(nsims)) / auto.mean(axis=0)
    nsig = np.abs(ratio - 1) / ratio_err
    # unbiased within MC errors and within 10% absolute
    assert np.all(np.abs(ratio - 1) < 0.12), (est, ratio)
    assert np.mean(np.abs(ratio - 1)) < 0.06, (est, ratio)
    assert np.all(nsig < 6.0), (est, ratio, nsig)


def test_n0_matches_recon_power(geom, th):
    """<|kappa_hat|^2> of *unlensed* sims equals N_L^0 (the Gaussian
    disconnected bias) — validates the A_L/N0 normalization integrals."""
    beam, noise = 1.5, 5.0
    ctot = qe.lensing_noise_2d(geom, th, beam, noise)
    xmask = F.mask_kspace(geom, lmin=100, lmax=3000)
    kmask = F.mask_kspace(geom, lmin=40, lmax=600)
    q = qe.QE(geom, th, ctot, xmask=xmask, kmask=kmask, dtype=jnp.float64)
    edges = np.arange(80, 560, 80.0)
    binner = Bin2D(geom.modlmap_np(), edges)
    kbeam = F.gauss_beam(geom.modlmap(jnp.float64), beam)
    norm = geom.area / geom.npix ** 2
    # unlensed (Gaussian, lensed-spectrum) sims with the same total power
    lmax = th.lpad
    ells = np.arange(lmax + 1)
    cltt = np.asarray(th.lCl("TT", ells))
    mgen = grf.MapGen(geom, cltt[None, None], dtype=jnp.float64)
    from orphics_tpu.geometry import arcmin as _am
    sigma = (noise * _am) / np.sqrt(geom.pixsize)

    @jax.jit
    def pipe(key):
        kc, kn = jax.random.split(key)
        cmb = mgen.get_map(kc)
        observed = F.kfilter(cmb, kbeam, geom) + sigma * jax.random.normal(
            kn, geom.shape, jnp.float64)
        kobs = jnp.fft.fft2(observed) / jnp.maximum(kbeam, 1e-8)
        fkrec = q.kappa_from_map("TT", kobs)
        auto = (fkrec.conj() * fkrec).real * norm
        return binner.bin(auto)[1]

    nsims = 48
    keys = jax.random.split(jax.random.PRNGKey(9), nsims)
    autos = np.asarray(jax.vmap(pipe)(keys))
    mean = autos.mean(axis=0)
    err = autos.std(axis=0, ddof=1) / np.sqrt(nsims)
    n0 = np.asarray(binner.bin(q.N_L_kk("TT"))[1])
    nsig = np.abs(mean - n0) / err
    assert np.all(np.abs(mean / n0 - 1) < 0.1), mean / n0
    assert np.mean(np.abs(mean / n0 - 1)) < 0.04, mean / n0


def test_nlgenerator_runs(geom, th):
    nlg = qe.NlGenerator(geom, th, np.arange(40, 500, 60.0))
    nlg.update_noise(beam_arcmin=1.4, noise_t_uk_arcmin=7.0)
    cents, nl = nlg.get_nl("TT")
    assert np.all(np.isfinite(nl)) and np.all(nl > 0)
    # SO-like config: N0_kk should be ~1e-8..1e-6 in this L range
    assert 1e-9 < np.median(nl) < 1e-5, nl
    cents, nl_mv = nlg.get_nl_mv(("TT", "EB"))
    assert np.all(nl_mv <= nl * 1.0001), (nl_mv, nl)


# ------------------------------------------------------------------
# Fused end-to-end lensing pipeline
# ------------------------------------------------------------------

def test_lenspipe_matches_unfused(geom, th):
    """LensedQEPipeline.step == the same pipeline assembled from the
    unfused validated pieces (rand_hermitian_half + lens_map_spline +
    kappa_tt_rfft), same PRNG keys, to fp32 accuracy."""
    from orphics_tpu.models import lenspipe, grf as _grf
    from orphics_tpu.ops import fourier as OF
    pipe = lenspipe.LensedQEPipeline(geom, th, beam_arcmin=2.0,
                                     noise_uk_arcmin=5.0, xlmax=3000,
                                     klmax=2000, lens_order=3)
    batch = 3
    key = jax.random.PRNGKey(21)
    got = np.asarray(pipe.step(key, batch))

    # unfused re-implementation with identical draws
    keys = jax.random.split(key, (batch, 3))
    ells = np.arange(th.lpad + 1)
    csq_tt = _grf.covsqrt_half(geom, ells, np.asarray(th.uCl("TT", ells)))
    rows = []
    for b in range(batch):
        eta_c = _grf.rand_hermitian_half(keys[b, 0], geom)
        eta_k = _grf.rand_hermitian_half(keys[b, 1], geom)
        eta_n = _grf.rand_hermitian_half(keys[b, 2], geom)
        unlensed = OF.irfft2(csq_tt * eta_c, geom)
        kin_h = pipe.csq_kk * eta_k
        alpha = OF.irfft2(pipe.alpha_filt * kin_h[None], geom)
        lensed = lensing.lens_map_spline(unlensed, alpha, geom, order=3)
        kobs_h = (pipe.kbeam_h * OF.rfft2(lensed, geom)
                  + pipe.ncov_h * eta_n)
        fk = pipe.qe.kappa_tt_rfft(kobs_h * pipe.inv_beam_h)
        cross = (fk.conj() * kin_h).real * pipe.norm
        auto_in = (kin_h.conj() * kin_h).real * pipe.norm
        auto_rec = (fk.conj() * fk).real * pipe.norm - pipe.n0_h
        rows.append(np.stack([np.asarray(pipe.binner.bin(x)[1])
                              for x in (cross, auto_in, auto_rec)]))
    ref = np.stack(rows)
    scale = np.abs(ref).max(axis=(0, 2), keepdims=True)
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-4)


