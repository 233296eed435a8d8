"""N1 lensing bias (models/qe.py n1_tt).

Two-layer validation:
1. Brute force — the FFT separable-term reduction must equal the
   direct 4D lattice double-sum of the Kesden-Cooray-Kamionkowski
   integrand on a small grid, to float64 roundoff. This pins the
   algebra (term split, padding/aliasing, every 2pi and area factor).
2. Physics — in a lensed-CMB Monte Carlo, recon auto - N0 - N1 must
   match the input C_L^kk better than - N0 alone at low L (the
   reference ecosystem's tt_verification excess). The MC leg lives in
   TestN1MonteCarlo (slow tier).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from orphics_tpu.geometry import rect_geometry
from orphics_tpu.models import theory, qe as qemod
from orphics_tpu.ops import fourier as F


def _clkk(th, lpad=None):
    ells = np.arange(th.lpad + 1 if lpad is None else lpad)
    return ells, np.asarray(th.gCl("kk", ells))


def _brute_n1_phi(qe, Lx, ells, clkk):
    """Direct 4D lattice sum: N1^pp(L)/A^2 = 2/area^2 *
    sum_{l1,l3} F(l1,l2) F(l3,l4) C^pp(|l1+l3|) f(l1,l3) f(l2,l4),
    l2 = L-l1, l4 = -L-l3, with the SAME radialized 1D tables n1_tt
    uses (so equality is exact, not statistical)."""
    from orphics_tpu.models.qe import _iso_profile
    geom = qe.geom
    lsafe = np.where(ells > 0, ells, 1.0)
    clpp = np.where(ells > 0, 4.0 * np.asarray(clkk) / lsafe ** 4, 0.0)
    lt, ct = _iso_profile(geom, qe.cl2d["TT"])
    _, ctot = _iso_profile(geom, qe.ctot["TT"])
    _, m1 = _iso_profile(geom, qe.gmask)
    _, m2 = _iso_profile(geom, qe.ymask)
    w1t = np.where(ctot > 0, m1 / np.where(ctot > 0, ctot, 1), 0.0)
    w2t = np.where(ctot > 0, m2 / np.where(ctot > 0, ctot, 1), 0.0)

    def cl(m):
        return np.interp(m, lt, ct, left=0.0, right=0.0)

    def w1(m):
        return np.interp(m, lt, w1t, left=0.0, right=0.0)

    def w2(m):
        return np.interp(m, lt, w2t, left=0.0, right=0.0)

    lmap = geom.lmap(jnp.float64)
    ly = np.asarray(lmap[0]).ravel()
    lx = np.asarray(lmap[1]).ravel()
    ml = np.hypot(lx, ly)
    l2x, l2y = Lx - lx, -ly
    l4x, l4y = -Lx - lx, -ly
    ml2 = np.hypot(l2x, l2y)
    ml4 = np.hypot(l4x, l4y)
    C1, C2, C4 = cl(ml), cl(ml2), cl(ml4)
    F12 = 0.5 * (C1 * (Lx * lx) + C2 * (Lx * l2x)) * w1(ml) * w2(ml2)
    F34 = 0.5 * (C1 * (-Lx * lx) + C4 * (-Lx * l4x)) * w1(ml) * w2(ml4)

    # pairwise grids over (i = l1 index, j = l3 index)
    dots13 = lx[:, None] * lx[None, :] + ly[:, None] * ly[None, :]
    f13 = (C1 * ml ** 2)[:, None] + (C1 * ml ** 2)[None, :] \
        + (C1[:, None] + C1[None, :]) * dots13
    dots24 = l2x[:, None] * l4x[None, :] + l2y[:, None] * l4y[None, :]
    f24 = (C2 * ml2 ** 2)[:, None] + (C4 * ml4 ** 2)[None, :] \
        + (C2[:, None] + C4[None, :]) * dots24
    msum = np.hypot(lx[:, None] + lx[None, :], ly[:, None] + ly[None, :])
    cpp = np.interp(msum, ells, clpp, left=0.0, right=0.0)
    tot = np.einsum("i,j,ij,ij,ij->", F12, F34, cpp, f13, f24,
                    optimize=True)
    f12 = C1 * (Lx * lx) + C2 * (Lx * l2x)
    invA = (f12 * F12).sum() / float(geom.area)
    return 2.0 * tot / float(geom.area) ** 2, 1.0 / invA


class TestN1BruteForce:
    @pytest.mark.quick
    def test_fft_reduction_matches_4d_lattice_sum(self):
        geom = rect_geometry(width_arcmin=24 * 8.0, px_res_arcmin=8.0)
        th = theory.default_theory()
        ctot = qemod.lensing_noise_2d(geom, th, 5.0, 15.0)
        q = qemod.QE(geom, th, ctot,
                     xmask=F.mask_kspace(geom, lmin=100, lmax=1200),
                     dtype=jnp.float64)
        ells, clkk = _clkk(th)
        dl = 2 * np.pi / np.radians(24 * 8.0 / 60.0)
        Ls = np.array([2 * dl, 5 * dl, 9 * dl])  # on- and off-lattice ok
        _, n1 = qemod.n1_tt(q, Ls, clkk, ells=ells, pad=2)
        for L, got in zip(Ls, n1):
            n1phi_over_a2, aL = _brute_n1_phi(q, L, ells, clkk)
            want = (L ** 4 / 4.0) * aL ** 2 * n1phi_over_a2
            assert want != 0.0
            assert abs(got / want - 1.0) < 1e-8, (L, got, want)

    def test_unpadded_lattice_aliases(self):
        """pad=1 must DIFFER from the exact answer when the masks allow
        |l1+l3| past Nyquist — the aliasing hazard pad=2 exists for."""
        geom = rect_geometry(width_arcmin=24 * 8.0, px_res_arcmin=8.0)
        th = theory.default_theory()
        ctot = qemod.lensing_noise_2d(geom, th, 5.0, 15.0)
        nyq = np.pi / np.radians(8.0 / 60.0)
        q = qemod.QE(geom, th, ctot,
                     xmask=F.mask_kspace(geom, lmin=100, lmax=0.95 * nyq),
                     dtype=jnp.float64)
        ells, clkk = _clkk(th)
        dl = 2 * np.pi / np.radians(24 * 8.0 / 60.0)
        Ls = np.array([3 * dl])
        _, n1_pad = qemod.n1_tt(q, Ls, clkk, ells=ells, pad=2)
        _, n1_nopad = qemod.n1_tt(q, Ls, clkk, ells=ells, pad=1)
        assert abs(n1_nopad[0] / n1_pad[0] - 1.0) > 1e-3

    def test_scales_with_clkk(self):
        """N1 is linear in the lensing spectrum."""
        geom = rect_geometry(width_arcmin=24 * 8.0, px_res_arcmin=8.0)
        th = theory.default_theory()
        ctot = qemod.lensing_noise_2d(geom, th, 5.0, 15.0)
        q = qemod.QE(geom, th, ctot,
                     xmask=F.mask_kspace(geom, lmin=100, lmax=1200),
                     dtype=jnp.float64)
        ells, clkk = _clkk(th)
        Ls = np.array([300.0])
        _, a = qemod.n1_tt(q, Ls, clkk, ells=ells)
        _, b = qemod.n1_tt(q, Ls, 3.0 * clkk, ells=ells)
        assert abs(b[0] / a[0] - 3.0) < 1e-6


class TestN1MonteCarlo:
    """Physics closure: in a lensed-CMB MC the connected recon-auto
    excess over (input Clkk + N0) IS N1. Calibrated on the real chip
    2026-08-20 (128 sims, 256^2 @2.5'): per-bin excess/N1 = 0.98-1.13
    at L = 430-910 where N1 is 5-7 sigma detectable, N0_mc/N0_an =
    0.98-1.00 everywhere. This CPU test reruns a reduced version and
    asserts the same closure on the summed high-significance band."""

    def test_lensed_mc_excess_is_n1(self):
        from orphics_tpu.models import lensing
        from orphics_tpu.ops.binning import Bin2D
        nsims = 160
        n, px = 128, 4.0
        beam, noise = 1.5, 5.0
        geom = rect_geometry(width_arcmin=n * px, px_res_arcmin=px)
        th = theory.default_theory()
        ctot = qemod.lensing_noise_2d(geom, th, beam, noise)
        q = qemod.QE(geom, th, ctot,
                     xmask=F.mask_kspace(geom, lmin=100, lmax=2500),
                     kmask=F.mask_kspace(geom, lmin=40, lmax=1200))
        fls = lensing.FlatLensingSims(geom, th, beam, noise)
        edges = np.arange(80, 1000, 115.0)
        binner = Bin2D(geom.modlmap_np(), edges)
        cents = binner.centers
        norm = jnp.asarray(float(geom.area) / float(geom.npix) ** 2)
        kbeam = jnp.maximum(
            F.gauss_beam(geom.modlmap(jnp.float32), beam), 1e-8)

        @jax.jit
        def one(key):
            obs, extras = fls.get_sim(key, return_intermediate=True)
            kmap = jnp.fft.fft2(jnp.squeeze(obs)) / kbeam
            krec = q.kappa_from_map("TT", kmap)
            kin = jnp.fft.fft2(jnp.squeeze(extras["kappa"]))
            auto = binner.bin((krec.conj() * krec).real * norm)[1]
            autoin = binner.bin((kin.conj() * kin).real * norm)[1]
            return auto, autoin, kmap

        keys = jax.random.split(jax.random.PRNGKey(7), nsims)
        autos, autoins, kmaps = jax.lax.map(one, keys)
        autos = np.asarray(autos)
        autoins = np.asarray(autoins)
        _, n0_mc = qemod.mcn0(q, "TT", kmaps, edges)
        n0_an = np.asarray(binner.bin(q.N_L_kk("TT"))[1])
        # MC N0 agrees with analytic N0 (matched spectra)
        good = n0_an > 0
        assert np.all(np.abs(n0_mc[good] / n0_an[good] - 1.0) < 0.15)

        ells, clkk = _clkk(th)
        _, n1 = qemod.n1_tt(q, cents, clkk, ells=ells)
        excess = autos.mean(0) - autoins.mean(0) - n0_mc
        err = (autos - autoins).std(0) / np.sqrt(nsims)
        # summed over the band where N1 is individually detectable,
        # the excess equals N1 (and is >3 sigma away from zero)
        band = (cents > 400) & (cents < 950) & (n1 > 3 * err)
        assert band.sum() >= 3, (n1 / err, cents)
        tot_ex, tot_n1 = excess[band].sum(), n1[band].sum()
        tot_err = np.sqrt((err[band] ** 2).sum())
        assert tot_ex > 3 * tot_err
        assert abs(tot_ex / tot_n1 - 1.0) < 0.35, (tot_ex, tot_n1)
