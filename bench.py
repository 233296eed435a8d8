"""Benchmarks: configs 1-8p, one JSON line each.

Headline (config 1, printed first): GRF-synthesize -> FFT -> binned-Cl
pipelines/sec at 2048^2 fp32 (``FastCl.sim_bandpowers``). The pipeline
per sim (reference call stack SURVEY §3.1):
  1. draw complex white noise on the rfft half plane,
  2. multiply by the precomputed covsqrt (lensed TT theory),
  3. inverse FFT -> real CMB map                   [the map materializes],
  4. forward FFT -> |.|^2 * area/npix^2            [FourierCalc.f2power],
  5. radial bin into 1D bandpowers                 [stats.bin2D].

Also measured:
  2. masked cross-spectra with Knox errors @ 2048^2
  3. TT quadratic-estimator kappa reconstruction-only @ 512^2, SO-like
     noise (stand-in half-plane sims; see bench_qe_recon docstring)
  4. 6-band tSZ-deprojected constrained-ILC coadds @ 512^2
  5. cluster stacking: batched inpaint + profile + NFW mass fit over
     10^4 cutouts
  6. honest end-to-end lensing MC @ 512^2: lensed sim (spline
     displacement) + beam + noise + QE recon + debiased spectra
  7. curved-sky SHT roundtrips at lmax 2047
  8. curved-sky masked-spectrum Monte Carlo at lmax 1023 (synalm +
     beam -> synthesis -> galactic mask -> analysis -> debiased Cls)
  8p. its spin-2 leg

Each config prints one JSON line {"metric", "value", "unit", "platform",
"device_kind", "device_count"}; every timed window ends in
``jax.block_until_ready``. Select with BENCH_CONFIGS="1,2,..." (default
all). Any failed config makes the run exit non-zero.
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
_RESULTS = []


def _emit(metric, value, unit, **extra):
    """Print one benchmark JSON line naming the device it ran on."""
    import jax
    dev = jax.devices()[0]
    obj = {"metric": metric, "value": value, "unit": unit,
           "platform": dev.platform, "device_kind": dev.device_kind,
           "device_count": len(jax.devices()), **extra}
    _RESULTS.append(obj)
    print(json.dumps(obj), flush=True)


def _maybe_trace(tag):
    """Profiler trace context for the timed reps when BENCH_TRACE is set
    (a logdir path); no-op otherwise."""
    logdir = os.environ.get("BENCH_TRACE")
    if not logdir:
        import contextlib
        return contextlib.nullcontext()
    from orphics_tpu.utils import profiling
    return profiling.trace(os.path.join(logdir, tag))


def _rate(tag, step, make_args, nrep, items_per_step):
    """Warm ``step`` up once, then time ``nrep`` calls ending in
    ``jax.block_until_ready``; returns items per second."""
    import jax
    jax.block_until_ready(step(*make_args(0)))
    with _maybe_trace(tag):
        t0 = time.perf_counter()
        out = None
        for i in range(nrep):
            out = step(*make_args(i + 1))
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
    return nrep * items_per_step / dt


def bench_headline():
    """Config 1: ``FastCl.sim_bandpowers`` at 2048^2, batch 192."""
    import jax
    from orphics_tpu import rect_geometry
    from orphics_tpu.maps import FastCl
    from orphics_tpu.models import theory

    n = int(os.environ.get("BENCH_N", 2048))
    batch = int(os.environ.get("BENCH_BATCH", 192))
    px = 0.5  # arcmin
    geom = rect_geometry(width_arcmin=n * px, px_res_arcmin=px)
    th = theory.default_theory()
    ells = np.arange(th.lpad + 1)
    cltt = np.asarray(th.lCl("TT", ells))
    fc = FastCl(geom, ells, cltt, bin_edges=np.arange(80, 8000, 80.0))
    step = jax.jit(lambda key: fc.sim_bandpowers(key, batch))
    rate = _rate("config1", step, lambda i: (jax.random.PRNGKey(i),),
                 int(os.environ.get("BENCH_REPS", 20)), batch)
    _emit(f"grf_fft_bin_pipelines_per_sec_{n}x{n}_fp32", rate,
          "pipelines/s", binning=fc.binner.strategy)


def bench_masked_cross():
    """Config 2: apodized-window cross-spectra with Knox errors @ 2048^2
    (FourierCalc.f2power + bin2D pattern, reference maps.py:1594)."""
    import jax
    import jax.numpy as jnp
    from orphics_tpu import rect_geometry
    from orphics_tpu.models import theory, grf
    from orphics_tpu.models.fastcl import FastCl
    from orphics_tpu.ops.windows import get_taper

    n = int(os.environ.get("BENCH2_N", 2048))
    batch = int(os.environ.get("BENCH2_BATCH", 128))
    px = 0.5
    geom = rect_geometry(width_arcmin=n * px, px_res_arcmin=px)
    th = theory.default_theory()
    ells = np.arange(th.lpad + 1)
    cltt = np.asarray(th.lCl("TT", ells))
    edges = np.arange(80, 8000, 80.0)
    fc = FastCl(geom, ells, cltt, bin_edges=edges)
    taper, w2 = get_taper(geom, taper_percent=12.0)
    taper = jnp.asarray(taper, jnp.float32)
    w2 = jnp.float32(w2)
    # taper-weighted effective sky fraction for the Knox factor
    fsky_eff = float(geom.area / (4 * np.pi)) * float(w2)
    cents = np.asarray(fc.centers)
    dl = float(edges[1] - edges[0])
    knox_fac = jnp.asarray(
        np.sqrt(2.0 / np.maximum((2 * cents + 1) * dl * fsky_eff,
                                 1e-30)),
        jnp.float32)

    covsqrt_h = fc._covsqrt_h

    @jax.jit
    def step(key):
        # fresh INDEPENDENT sim pairs (throughput workload: the cross
        # spectra are consistent with zero; what is measured is the
        # masked cross-spectrum pipeline rate, not a signal) -> mask ->
        # cross spectra -> debias by w2 -> Knox error bars
        keys = jax.random.split(key, batch)
        maps = jax.vmap(lambda k: grf.rand_map_r(k, geom, covsqrt_h))(keys)
        npairs = batch // 2
        bs = fc.cross_bandpowers(maps[:npairs], maps[npairs:],
                                 window=taper) / w2
        return bs, bs * knox_fac

    rate = _rate("config2", step, lambda i: (jax.random.PRNGKey(i),),
                 int(os.environ.get("BENCH2_REPS", 10)), batch // 2)
    _emit(f"masked_cross_spectra_per_sec_{n}x{n}_fp32", rate,
          "cross-spectra/s")


def bench_qe_recon():
    """Config 3: TT QE kappa *reconstruction-only* rate @ 512^2 with
    SO-like noise, N_L^0-debiased binned auto spectrum included (the
    Lensing-noise-curves pattern).

    What this measures — and what it does not: the timed loop draws
    stand-in observed fields directly on the rfft half-plane from the
    lensed-TT theory (zero transforms, no lensing operation, no beam
    convolution / noise realization in the field), then runs the full
    fused half-plane reconstruction (filters + QE + N0-debias + bin).
    It is a *reconstruction throughput* number. The honest end-to-end
    rate (lensed sim + beam + noise + recon) is config 6
    (:func:`bench_lensed_e2e`)."""
    import jax
    import jax.numpy as jnp
    from orphics_tpu import rect_geometry
    from orphics_tpu.models import theory, qe, grf
    from orphics_tpu.ops import fourier as F
    from orphics_tpu.ops.binning import Bin2D

    from orphics_tpu.ops.binning import RfftBin2D

    n = int(os.environ.get("BENCH3_N", 512))
    batch = int(os.environ.get("BENCH3_BATCH", 64))
    px = 2.0
    geom = rect_geometry(width_arcmin=n * px, px_res_arcmin=px)
    th = theory.default_theory()
    beam, noise = 1.4, 6.0  # SO-like LAT
    ctot = qe.lensing_noise_2d(geom, th, beam, noise)
    lmax_grid = geom.ellmax_safe()
    q = qe.QE(geom, th, ctot,
              xmask=F.mask_kspace(geom, lmin=100,
                                  lmax=min(3000, lmax_grid - 1)),
              kmask=F.mask_kspace(geom, lmin=40,
                                  lmax=min(3000, lmax_grid * 0.8)))
    nxr = geom.nx // 2 + 1
    n0_h = q.N_L_kk("TT")[:, :nxr]
    edges = np.arange(40, 2000, 80.0)
    binner = RfftBin2D(geom, edges)
    ells = np.arange(th.lpad + 1)
    cltt = np.asarray(th.lCl("TT", ells))
    # Fused path: synthesize the stand-in observed sims directly on the
    # Fourier plane (exactly the spectrum of a real GRF map; zero
    # transforms), then the fused TT reconstruction.
    norm = jnp.float32(geom.area / geom.npix ** 2)

    covsqrt_h = grf.covsqrt_half(geom, ells, cltt, dtype=jnp.float32)

    @jax.jit
    def step(key):
        keys = jax.random.split(key, batch)
        eta = jax.vmap(lambda k: grf.rand_hermitian_half(k, geom))(keys)
        kobs_h = covsqrt_h * eta                    # stand-in observed sims
        fk = q.kappa_tt_rfft(kobs_h)
        p2d = (fk.conj() * fk).real * norm - n0_h[None]
        _, p1d = binner.bin(p2d)
        return p1d

    rate = _rate("config3", step, lambda i: (jax.random.PRNGKey(i),),
                 int(os.environ.get("BENCH3_REPS", 20)), batch)
    _emit(f"qe_tt_recon_only_per_sec_{n}x{n}_fp32", rate, "recons/s")


def bench_lensed_e2e():
    """Config 6: honest end-to-end lensing MC rate @ 512^2 — what the
    reference's tt_verification loop does per iteration (FlatLensingSims
    .get_sim + QE recon, reference lensing.py:458-516): unlensed CMB GRF
    -> kappa GRF -> deflection -> spline displacement -> beam +
    white noise -> deconvolve -> fused TT QE -> N0-debiased binned
    auto/cross spectra. One number = complete sim+recon pipelines/s."""
    import jax
    from orphics_tpu import rect_geometry
    from orphics_tpu.models import theory, lenspipe

    n = int(os.environ.get("BENCH6_N", 512))
    batch = int(os.environ.get("BENCH6_BATCH", 64))
    px = 2.0
    geom = rect_geometry(width_arcmin=n * px, px_res_arcmin=px)
    th = theory.default_theory()
    pipe = lenspipe.LensedQEPipeline(geom, th, lens_order=5)

    rate = _rate("config6", lambda k: pipe.step(k, batch),
                 lambda i: (jax.random.PRNGKey(i),),
                 int(os.environ.get("BENCH6_REPS", 10)), batch)
    _emit(f"lensed_sim_plus_qe_recon_per_sec_{n}x{n}_fp32", rate,
          "sim+recon/s")


def bench_ilc():
    """Config 4: 6-band tSZ-deprojected constrained ILC map coadds @
    512^2 (harmonic-ILC pattern, reference ilc.py)."""
    import jax
    import jax.numpy as jnp
    from orphics_tpu import rect_geometry
    from orphics_tpu.models import theory, ilc, foregrounds as fg, grf
    from orphics_tpu.ops.fourier import gauss_beam
    from orphics_tpu.geometry import arcmin

    n = int(os.environ.get("BENCH4_N", 512))
    batch = int(os.environ.get("BENCH4_BATCH", 32))
    geom = rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    freqs = np.array([39.0, 93.0, 145.0, 225.0, 280.0, 350.0])
    beams = np.array([5.1, 2.2, 1.4, 1.0, 0.9, 0.8])
    noises = np.array([36.0, 8.0, 10.0, 22.0, 54.0, 100.0])
    nf = len(freqs)
    th = theory.default_theory()
    ellmax = int(geom.ellmax_safe())
    ells = np.arange(2, ellmax)
    cltt = np.asarray(th.lCl("TT", ells))
    kbeams = [np.asarray(gauss_beam(ells, b)) for b in beams]
    cinv1d, _ = ilc.ilc_cinv(ells, cltt, kbeams, freqs,
                             (noises * arcmin) ** 2,
                             components=("tsz", "cibc", "ksz"),
                             fdict=fg.fg_dict(10.0 + 0 * freqs, freqs))
    ml = geom.modlmap_np()
    cinv1d = np.asarray(cinv1d)                  # (nf, nf, nells)
    cinv2d = np.zeros((nf, nf, n, n), np.float32)
    for i in range(nf):
        for j in range(nf):
            cinv2d[i, j] = np.interp(ml, ells, cinv1d[i, j],
                                     left=0, right=0)
    cinv2d = jnp.asarray(cinv2d)
    a_cmb = jnp.ones(nf, jnp.float32)
    a_tsz = jnp.asarray(np.asarray(fg.g_tsz(freqs)), jnp.float32)
    ells_full = np.arange(th.lpad + 1)
    cltt_full = np.asarray(th.lCl("TT", ells_full))

    # the cILC is linear in the maps: its per-band weights are a static
    # 2D filter, computed once
    w2d = np.asarray(ilc.cilc_weights(cinv2d, a_cmb, a_tsz), np.float32)
    mgen = grf.MapGen(geom, cltt_full[None, None])

    @jax.jit
    def step(key):
        keys = jax.random.split(key, batch * nf)
        maps6 = jax.vmap(mgen.get_map)(keys).reshape(batch, nf, n, n)
        coadds = ilc.linear_coadd_fused(maps6, w2d)
        return coadds.mean(axis=(-2, -1))

    rate = _rate("config4", step, lambda i: (jax.random.PRNGKey(i),),
                 int(os.environ.get("BENCH4_REPS", 20)), batch)
    _emit(f"ilc_6band_deproj_coadds_per_sec_{n}x{n}_fp32", rate,
          "coadds/s")


def bench_stack():
    """Config 5: cluster stacking — batched max-likelihood inpainting +
    kappa profile binning + NFW mass chi^2 over 10^4 cutouts
    (reference examples/inpainting + lensing.fit_nfw_profile pattern)."""
    import jax
    import jax.numpy as jnp
    from orphics_tpu import rect_geometry
    from orphics_tpu.geometry import Geometry, arcmin
    from orphics_tpu.models import theory, pixcov, nfwfit, cosmology, grf
    from orphics_tpu.ops import fourier as F
    from orphics_tpu.ops.binning import Bin2D

    nstamp = int(os.environ.get("BENCH5_NSTAMP", 10000))
    npix = 64
    res = 0.5
    gs = Geometry(npix, npix, res * arcmin, res * arcmin)
    th = theory.default_theory()
    beam_fn = lambda l: F.gauss_beam(l, 1.4)

    # one shared hole geometry (same radius every stamp): covsqrt/meanmul
    # precomputed once, fill is a batched matmul
    m1, m2 = pixcov.get_geometry_regions(1, npix, res * arcmin,
                                         5.0 * arcmin)
    scov = pixcov.scov_from_theory(gs, th, beam_fn, ncomp=1)
    nvar = (10.0 * arcmin) ** 2 / (gs.dy * gs.dx)  # 10 uK-arcmin white
    pcov = jnp.asarray(scov) + nvar * jnp.eye(scov.shape[-1])
    covsqrt, meanmul = pixcov.make_geometry(pcov, jnp.asarray(m1),
                                            jnp.asarray(m2), ncomp=1)

    # NFW mass templates on the stamp's profile bins
    cc = cosmology.Cosmology()
    masses = np.geomspace(5e13, 8e14, 16)
    redges = np.arange(0.0, 10.0, 1.0) * arcmin
    modr = gs.modrmap_np()
    pbin = Bin2D(modr, redges)
    temps = []
    for m in masses:
        k2d = nfwfit.nfw_kappa(m, jnp.asarray(modr), cc)
        _, prof = pbin.bin(k2d)
        temps.append(np.asarray(prof))
    temps = jnp.asarray(np.asarray(temps), jnp.float32)  # (nm, nb)
    nb = temps.shape[-1]
    cinv = jnp.eye(nb, dtype=jnp.float32) * 1e4

    ells = np.arange(th.lpad + 1)
    mgen = grf.MapGen(gs, np.asarray(th.lCl("TT", ells))[None, None])
    m1j, m2j = jnp.asarray(m1), jnp.asarray(m2)

    @jax.jit
    def step(key):
        keys = jax.random.split(key, nstamp)
        stamps = jax.vmap(mgen.get_map)(keys)[:, None]     # (B,1,n,n)
        B = stamps.shape[0]
        cs = jnp.broadcast_to(covsqrt, (B,) + covsqrt.shape)
        mm = jnp.broadcast_to(meanmul, (B,) + meanmul.shape)
        filled = pixcov.inpaint_stamps_batched(stamps, cs, mm, m1j, m2j)
        _, profs = pbin.bin(filled[:, 0])                  # (B, nb)
        diff = profs[:, None, :] - temps[None, :, :]       # (B, nm, nb)
        chi2 = jnp.einsum("bmi,ij,bmj->bm", diff, cinv, diff)
        best = jnp.argmin(chi2, axis=1)
        return best

    rate = _rate("config5", step, lambda i: (jax.random.PRNGKey(i),),
                 int(os.environ.get("BENCH5_REPS", 5)), nstamp)
    _emit(f"stack_inpaint_nfwfit_stamps_per_sec_{npix}x{npix}", rate,
          "stamps/s")


def bench_sht():
    """Config 7: curved-sky SHT roundtrips (alm2map + map2alm) at
    lmax 2047 on Gauss-Legendre rings, fp32 (the reference's
    libsharp/ducc workload, ``orphics/maps.py:2``)."""
    import jax
    import jax.numpy as jnp
    from orphics_tpu.ops import sht

    lmax = int(os.environ.get("BENCH7_LMAX", 2047))
    rings = sht.gauss_legendre_rings(lmax)
    nalm = (lmax + 1) * (lmax + 2) // 2

    batch = int(os.environ.get("BENCH7_BATCH", 1))

    @jax.jit
    def mkalm(key):
        kr, ki = jax.random.split(key)
        shp = (nalm,) if batch == 1 else (batch, nalm)
        a = (jax.random.normal(kr, shp, jnp.float32)
             + 1j * jax.random.normal(ki, shp, jnp.float32))
        return a.at[..., : lmax + 1].set(
            jnp.real(a[..., : lmax + 1]).astype(jnp.complex64))

    a0 = mkalm(jax.random.PRNGKey(0))
    err = float(jnp.abs(sht.map2alm(sht.alm2map(a0, rings, lmax), rings,
                                    lmax) - a0).max())
    assert err < 1e-3, f"SHT roundtrip error {err}"

    def roundtrip(a):
        return sht.map2alm(sht.alm2map(a, rings, lmax), rings, lmax)

    rate = _rate("config7", roundtrip, lambda i: (a0,),
                 int(os.environ.get("BENCH7_REPS", 10)), batch)
    tag = f"sht_roundtrips_per_sec_lmax{lmax}" \
        + (f"_batch{batch}" if batch > 1 else "")
    _emit(tag, rate, "roundtrips/s", maxerr=err)


def bench_curved_mc():
    """Config 8: curved-sky masked-spectrum Monte Carlo — the full-sky
    analog of config 2 (reference: ``cs.rand_map`` + smoothing +
    galactic mask + ``hp.anafast``/``map2alm`` loops,
    ``orphics/maps.py:744,1009``). Per sim: on-the-fly synalm with a
    Gaussian beam, synthesis to Gauss-Legendre rings, galactic-strip
    masking, analysis back to alm, mask-debiased Cls — 2 batched SHTs
    per step."""
    import jax
    import jax.numpy as jnp
    from orphics_tpu.ops import sht
    from orphics_tpu.ops import alm as almops
    from orphics_tpu.models import curved, theory

    lmax = int(os.environ.get("BENCH8_LMAX", 1023))
    batch = int(os.environ.get("BENCH8_BATCH", 8))
    rings = sht.gauss_legendre_rings(lmax)
    th = theory.default_theory()
    ells = np.arange(lmax + 1)
    cltt = jnp.asarray(np.asarray(th.lCl("TT", ells)), jnp.float32)
    fwhm = 10.0  # arcmin
    sig = np.deg2rad(fwhm / 60.0) / np.sqrt(8.0 * np.log(2.0))
    bl = jnp.asarray(np.exp(-0.5 * ells * (ells + 1.0) * sig * sig),
                     jnp.float32)
    mask = jnp.asarray(np.asarray(curved.galactic_mask_rings(
        rings, np.deg2rad(76.0), np.deg2rad(104.0), coords="equ")),
        jnp.float32)
    w2 = float(curved.wfactor(2, mask, rings))

    @jax.jit
    def step(key):
        keys = jax.random.split(key, batch)
        alms = jax.vmap(lambda k: almops.synalm(k, cltt, lmax=lmax))(keys)
        m = sht.alm2map(almops.almxfl(alms, bl), rings, lmax)
        a2 = sht.map2alm(m * mask, rings, lmax)
        return jax.vmap(almops.alm2cl)(a2) / w2

    sel = (ells > 100) & (ells < lmax // 2)
    want = (np.asarray(cltt) * np.asarray(bl) ** 2)[sel]
    ratio = np.asarray(step(jax.random.PRNGKey(0))).mean(0)[sel] / want
    assert abs(ratio.mean() - 1.0) < 0.2, ratio.mean()
    rate = _rate("config8", step, lambda i: (jax.random.PRNGKey(i),),
                 int(os.environ.get("BENCH8_REPS", 10)), batch)
    _emit(f"curved_masked_cl_sims_per_sec_lmax{lmax}_batch{batch}", rate,
          "sims/s")


def bench_curved_mc_pol():
    """Config 8p: the spin-2 leg of config 8 — per sim an (E, B) synalm
    pair with a Gaussian beam, ``alm2map_spin`` to (Q, U) on
    Gauss-Legendre rings, galactic-strip masking, ``map2alm_spin``
    back, and mask-debiased EE+BB (the leakage-invariant total; a pure
    w2 debias does not separate E/B mixing). Exercises the spin
    transforms the scalar config never touches (reference role:
    ``cs.rand_map(..., pol)`` + ``hp.map2alm_spin`` loops)."""
    import jax
    import jax.numpy as jnp
    from orphics_tpu.ops import sht
    from orphics_tpu.ops import alm as almops
    from orphics_tpu.models import curved, theory

    lmax = int(os.environ.get("BENCH8_LMAX", 1023))
    batch = int(os.environ.get("BENCH8_BATCH", 8))
    rings = sht.gauss_legendre_rings(lmax)
    th = theory.default_theory()
    ells = np.arange(lmax + 1)
    clee = np.asarray(th.lCl("EE", ells))
    clbb = np.asarray(th.lCl("BB", ells))
    clee_j = jnp.asarray(clee, jnp.float32)
    clbb_j = jnp.asarray(clbb, jnp.float32)
    fwhm = 10.0
    sig = np.deg2rad(fwhm / 60.0) / np.sqrt(8.0 * np.log(2.0))
    bl = jnp.asarray(np.exp(-0.5 * ells * (ells + 1.0) * sig * sig),
                     jnp.float32)
    mask = jnp.asarray(np.asarray(curved.galactic_mask_rings(
        rings, np.deg2rad(76.0), np.deg2rad(104.0), coords="equ")),
        jnp.float32)
    w2 = float(curved.wfactor(2, mask, rings))

    @jax.jit
    def step(key):
        keys = jax.random.split(key, 2 * batch).reshape(batch, 2, 2)
        ealm = jax.vmap(lambda k: almops.almxfl(
            almops.synalm(k, clee_j, lmax=lmax), bl))(keys[:, 0])
        balm = jax.vmap(lambda k: almops.almxfl(
            almops.synalm(k, clbb_j, lmax=lmax), bl))(keys[:, 1])
        q, u = sht.alm2map_spin(ealm, balm, rings, lmax)
        e2, b2 = sht.map2alm_spin(q * mask, u * mask, rings, lmax)
        return (jax.vmap(almops.alm2cl)(e2)
                + jax.vmap(almops.alm2cl)(b2)) / w2

    sel = (ells > 100) & (ells < lmax // 2)
    want = ((clee + clbb) * np.asarray(bl) ** 2)[sel]
    ratio = np.asarray(step(jax.random.PRNGKey(0))).mean(0)[sel] / want
    assert abs(ratio.mean() - 1.0) < 0.2, ratio.mean()
    rate = _rate("config8p", step, lambda i: (jax.random.PRNGKey(i),),
                 int(os.environ.get("BENCH8_REPS", 10)), batch)
    _emit(f"curved_masked_pol_sims_per_sec_lmax{lmax}_batch{batch}", rate,
          "sims/s")


def main():
    import traceback
    import warnings
    import jax
    from orphics_tpu.utils import compile_cache
    compile_cache.enable(ROOT)
    configs = [c.strip() for c in os.environ.get(
        "BENCH_CONFIGS", "1,2,3,4,5,6,7,8,8p").split(",") if c.strip()]
    fns = {"1": bench_headline, "2": bench_masked_cross,
           "3": bench_qe_recon, "4": bench_ilc, "5": bench_stack,
           "6": bench_lensed_e2e, "7": bench_sht, "8": bench_curved_mc,
           "8p": bench_curved_mc_pol}
    failed = []
    # Self-check: no config may request device float64 on an x64-off
    # runtime (jax warns and silently truncates — binner-edge hazard).
    with warnings.catch_warnings(record=True) as wrec:
        warnings.simplefilter("always")
        for c in configs:
            try:
                fns[c]()
            except Exception as e:  # report, run the others, fail at exit
                failed.append(c)
                traceback.print_exc()
                print(json.dumps({"metric": f"config{c}_error",
                                  "error": f"{type(e).__name__}: {e}"[:300],
                                  "platform": jax.devices()[0].platform}),
                      file=sys.stderr, flush=True)
        trunc = [str(w.message)[:160] for w in wrec
                 if "float64" in str(w.message)
                 and "truncat" in str(w.message).lower()]
    if trunc:
        print(f"BENCH SELF-CHECK FAILED: {len(trunc)} float64-truncation "
              "warnings (device f64 requested on an x64-off runtime): "
              f"{trunc[:3]}", file=sys.stderr)
    if failed or trunc:
        sys.exit(f"bench: failed configs {failed}" if failed else 2)


if __name__ == "__main__":
    main()
