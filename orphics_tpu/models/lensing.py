"""Flat-sky CMB lensing: kappa/phi/deflection calculus, map lensing
operators, lensed simulations, and NFW halo profiles.

JAX re-design of reference ``orphics/lensing.py``:
  * ``kappa_to_phi/fkappa_to_fphi`` (reference ``lensing.py:651-665``):
    phi(l) = 2 kappa(l) / (l (l+1)), zeroed below l=2.
  * ``alpha_from_kappa`` (``lensing.py:443``): deflection = grad(phi) via
    i*l multiplication.
  * Map lensing:
      - :func:`lens_map_spline`: B-spline interpolation at displaced
        positions, the role of ``pixell.lensing.displace_map``
        (``lensing.py:512``). The periodic prefilter is exact in Fourier
        space (deconvolve the B-spline kernel response) — no sequential
        IIR filters, so it jits cleanly; the 4x4 (order 3) or 6x6
        (order 5) tap evaluation is a static-stencil gather.
      - :func:`taylens`: integer-pixel shift + Taylor expansion of the
        sub-pixel remainder (reference ``flat_taylens``,
        ``lensing.py:395``, after Naess & Louis 2013).
  * :class:`FlatLensingSims` (``lensing.py:458``): unlensed GRF + kappa
    GRF -> lens -> beam -> noise, fully batched with PRNG keys.
  * NFW kappa profiles (``lensing.py:701-770,909-956``) as pure jnp math.
"""
from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import Geometry, arcmin
from ..ops import fourier as F
from . import grf as _grf

__all__ = [
    "fkappa_to_fphi", "kappa_to_phi", "kappa_to_fphi", "alpha_from_kappa",
    "gradient", "lens_map_spline", "taylens", "FlatLensingSims",
    "gnfw", "f_c", "fnfw", "rho_nfw", "proj_rho_nfw", "projected_rho",
    "kappa_nfw_generic", "kappa_generic", "nfw_kappa_profile",
    "sanitize_power", "fill_low_ell",
]


# ------------------------------------------------------------------
# kappa <-> phi <-> deflection
# ------------------------------------------------------------------

def fkappa_to_fphi(fkappa, geom: Geometry):
    """phi(l) = 2 kappa(l) / (l(l+1)), zero for l < 2
    (reference ``lensing.py:662``)."""
    modlmap = geom.modlmap(jnp.float32)
    denom = modlmap * (modlmap + 1.0)
    fphi = jnp.where(denom > 0, 2.0 * fkappa / jnp.where(denom > 0, denom, 1.0), 0.0)
    return jnp.where(modlmap < 2.0, 0.0, fphi)


def kappa_to_fphi(kappa, geom: Geometry):
    return fkappa_to_fphi(F.fft2(kappa, geom, "phys"), geom)


@partial(jax.jit, static_argnames=("geom",))
def kappa_to_phi(kappa, geom: Geometry):
    """Convergence map -> lensing potential map (reference ``lensing.py:651``)."""
    return F.ifft2(kappa_to_fphi(kappa, geom), geom, "phys").real


def gradient(x, geom: Geometry):
    """(2, ny, nx) gradient via Fourier i*l multiplication (enmap.grad)."""
    k = F.fft2(x, geom, "raw")
    lmap = geom.lmap(jnp.float32)
    gy = F.ifft2(1j * lmap[0] * k, geom, "raw").real
    gx = F.ifft2(1j * lmap[1] * k, geom, "raw").real
    return jnp.stack([gy, gx])


@partial(jax.jit, static_argnames=("geom",))
def alpha_from_kappa(kappa, geom: Geometry):
    """Deflection field (2, ny, nx) = grad(phi) from a kappa map
    (reference ``lensing.py:443`` with ``grad=True``)."""
    fphi = kappa_to_fphi(kappa, geom)
    lmap = geom.lmap(jnp.float32)
    # phys-normalized ifft of i*l*fphi
    ay = F.ifft2(1j * lmap[0] * fphi, geom, "phys").real
    ax = F.ifft2(1j * lmap[1] * fphi, geom, "phys").real
    return jnp.stack([ay, ax])


# ------------------------------------------------------------------
# Spline-interpolated displacement (displace_map equivalent)
# ------------------------------------------------------------------
def _bspline3_weights(t):
    """Cubic B-spline basis at taps floor+(-1,0,1,2) for fraction t."""
    w0 = (1.0 - t) ** 3 / 6.0
    w1 = 2.0 / 3.0 - t * t + 0.5 * t ** 3
    w2 = 2.0 / 3.0 - (1 - t) ** 2 + 0.5 * (1 - t) ** 3
    w3 = t ** 3 / 6.0
    return (w0, w1, w2, w3)


def _bspline5_weights(t):
    """Quintic B-spline basis at taps floor+(-2..3) for fraction t."""
    def b5(x):
        ax = jnp.abs(x)
        r = jnp.where(ax < 1, (33.0 - 30 * ax ** 2 + 15 * ax ** 4
                               - 5 * ax ** 5) / 60.0, 0.0)
        r = jnp.where((ax >= 1) & (ax < 2),
                      (51.0 + 75 * ax - 210 * ax ** 2 + 150 * ax ** 3
                       - 45 * ax ** 4 + 5 * ax ** 5) / 120.0, r)
        return jnp.where((ax >= 2) & (ax < 3), (3.0 - ax) ** 5 / 120.0, r)
    return tuple(b5(t - m) for m in (-2, -1, 0, 1, 2, 3))


def _bspline_freq_response(n, order):
    """Frequency response of the centered B-spline sampling kernel."""
    taps = {3: np.array([1.0, 4.0, 1.0]) / 6.0,
            5: np.array([1.0, 26.0, 66.0, 26.0, 1.0]) / 120.0}[order]
    w = 2 * np.pi * np.fft.fftfreq(n)
    half = (len(taps) - 1) // 2
    resp = np.full(n, taps[half])
    for j in range(1, half + 1):
        resp = resp + 2.0 * taps[half + j] * np.cos(j * w)
    return resp


def _spline_coeffs(imap, geom: Geometry, order: int):
    """Periodic B-spline coefficients of ``imap`` via the exact Fourier
    prefilter (deconvolve the sampling-kernel response)."""
    ry = jnp.asarray(_bspline_freq_response(geom.ny, order), jnp.float32)
    rx = jnp.asarray(_bspline_freq_response(geom.nx, order), jnp.float32)
    k = F.fft2(imap, geom, "raw")
    return F.ifft2(k / (ry[:, None] * rx[None, :]), geom, "raw").real


@partial(jax.jit, static_argnames=("geom", "order"))
def lens_map_spline(imap, alpha, geom: Geometry, order: int = 5):
    """Evaluate ``imap`` at positions displaced by the deflection ``alpha``
    (radians, (2, ny, nx)), with periodic boundaries — the
    ``pixell.lensing.displace_map`` role (reference ``lensing.py:512``).

    B-spline interpolation of the given ``order`` (3 or 5) with the exact
    periodic prefilter applied in Fourier space. ``imap`` may carry leading
    component axes.
    """
    if order not in (3, 5):
        raise ValueError("order must be 3 or 5")
    coeffs = _spline_coeffs(imap, geom, order)
    return _eval_spline_coeffs(coeffs, alpha, geom, order)


@partial(jax.jit, static_argnames=("geom", "order"))
def _eval_spline_coeffs(coeffs, alpha, geom: Geometry, order: int):
    """Evaluate prefiltered spline coefficients at displaced positions
    (the gather half of :func:`lens_map_spline`; pipelines that
    synthesize coefficients directly, such as LensedQEPipeline, call
    this without the prefilter)."""
    py = alpha[0] / geom.dy
    px = alpha[1] / geom.dx
    iy = jnp.arange(geom.ny, dtype=jnp.float32)[:, None] + py
    ix = jnp.arange(geom.nx, dtype=jnp.float32)[None, :] + px
    yb = jnp.floor(iy)
    xb = jnp.floor(ix)
    ty = iy - yb
    tx = ix - xb
    yb = yb.astype(jnp.int32)
    xb = xb.astype(jnp.int32)

    if order == 3:
        wys = _bspline3_weights(ty)
        wxs = _bspline3_weights(tx)
        offs = (-1, 0, 1, 2)
    else:
        wys = _bspline5_weights(ty)
        wxs = _bspline5_weights(tx)
        offs = (-2, -1, 0, 1, 2, 3)

    # One shared-index gather instead of (order+1)^2 separate gathers:
    # pre-shift the coefficient map by every static stencil offset with
    # dense rolls, stack as channels, and gather all taps at the *same*
    # base index (one index computation serves every tap).
    yy = jnp.mod(yb, geom.ny)
    xx = jnp.mod(xb, geom.nx)
    base_idx = (yy * geom.nx + xx).reshape(-1)
    shifted = jnp.stack([
        jnp.roll(coeffs, (-m, -no), axis=(-2, -1))
        for m in offs for no in offs])                  # (ntap, ..., ny, nx)
    ntap = shifted.shape[0]
    sflat = shifted.reshape((ntap,) + coeffs.shape[:-2] + (-1,))
    vals = jnp.take(sflat, base_idx, axis=-1)           # shared indices
    vals = vals.reshape((ntap,) + coeffs.shape)
    out = jnp.zeros_like(coeffs)
    t = 0
    for mi in range(len(offs)):
        for ni in range(len(offs)):
            out = out + wys[mi] * wxs[ni] * vals[t]
            t += 1
    return out


@partial(jax.jit, static_argnames=("geom", "order"))
def taylens(imap, alpha, geom: Geometry, order: int = 5):
    """Lens via integer-pixel displacement + Taylor series of the sub-pixel
    remainder (reference ``flat_taylens``, ``lensing.py:395``; Naess &
    Louis 2013). FFT-heavy and gather-light: one nearest-pixel gather per
    derivative field, all derivative algebra on the Fourier plane.
    """
    py = alpha[0] / geom.dy
    px = alpha[1] / geom.dx
    ay0 = jnp.round(py)
    ax0 = jnp.round(px)
    dy = (py - ay0) * geom.dy
    dx = (px - ax0) * geom.dx
    iy = jnp.arange(geom.ny, dtype=jnp.float32)[:, None] + ay0
    ix = jnp.arange(geom.nx, dtype=jnp.float32)[None, :] + ax0
    idx = (jnp.mod(iy.astype(jnp.int32), geom.ny) * geom.nx
           + jnp.mod(ix.astype(jnp.int32), geom.nx)).reshape(-1)

    kmap = F.fft2(imap, geom, "phys")
    lmap = geom.lmap(jnp.float32)
    ly, lx = lmap[0], lmap[1]
    # build all derivative fields, then evaluate them at the displaced
    # integer positions with ONE shared-index gather
    fields = [imap]
    monomials = [jnp.ones_like(dx)]
    for n in range(1, order):
        fac0 = 1.0 / math.factorial(n)
        for k in range(n + 1):
            binom = math.comb(n, k)
            fields.append(F.ifft2((1j ** n) * (lx ** (n - k)) * (ly ** k)
                                  * kmap, geom, "phys").real)
            monomials.append((dx ** (n - k)) * (dy ** k) * (fac0 * binom))
    stack = jnp.stack(fields)
    vals = jnp.take(stack.reshape(stack.shape[0], -1), idx, axis=-1)
    vals = vals.reshape(stack.shape[0:1] + imap.shape)
    out = jnp.zeros_like(imap)
    for i, mono in enumerate(monomials):
        out = out + vals[i] * mono
    return out


# ------------------------------------------------------------------
# Lensed simulations
# ------------------------------------------------------------------

class FixedLens:
    """Lensed sims with a *fixed* deflection profile (e.g. a cluster halo):
    unlensed GRF -> displace by the fixed alpha (reference ``FixedLens``,
    ``lensing.py:30``)."""

    def __init__(self, geom: Geometry, theory, kappa_fixed, lens_order: int = 5,
                 pol: bool = False, dtype=jnp.float32):
        self.geom = geom
        self.lens_order = lens_order
        lmax = int(geom.lmax()) + 1
        ells = np.arange(lmax)
        ncomp = 3 if pol else 1
        ps = np.zeros((ncomp, ncomp, lmax))
        ps[0, 0] = np.asarray(theory.uCl("TT", ells))
        if pol:
            ps[1, 1] = np.asarray(theory.uCl("EE", ells))
            ps[2, 2] = np.asarray(theory.uCl("BB", ells))
            te = np.asarray(theory.uCl("TE", ells))
            ps[0, 1] = ps[1, 0] = te
        self.mgen = _grf.MapGen(geom, ps, dtype=dtype)
        self.kappa = jnp.asarray(kappa_fixed, dtype)
        self.alpha = alpha_from_kappa(self.kappa, geom)

    def update_kappa(self, kappa):
        self.kappa = jnp.asarray(kappa)
        self.alpha = alpha_from_kappa(self.kappa, self.geom)

    def generate_sim(self, key):
        unlensed = self.mgen.get_map(key)
        lensed = lens_map_spline(unlensed, self.alpha, self.geom,
                                 order=self.lens_order)
        return unlensed, lensed


class FlatLensingSims:
    """Batched lensed CMB simulations (reference ``FlatLensingSims``,
    ``lensing.py:458``): unlensed GRF (+pol), GRF kappa, spline lensing,
    Gaussian beam, white noise.

    >>> fls = FlatLensingSims(geom, theory, beam_arcmin=1.4, noise_uk_arcmin=7)
    >>> obs = fls.get_sim(key)                      # observed map(s)
    >>> obs, extras = fls.get_sim(key, return_intermediate=True)
    """

    def __init__(self, geom: Geometry, theory, beam_arcmin, noise_uk_arcmin,
                 noise_e_uk_arcmin=None, noise_b_uk_arcmin=None,
                 pol: bool = False, lens_order: int = 5,
                 lens_method: str = "spline", dtype=jnp.float32):
        self.geom = geom
        self.pol = pol
        self.lens_order = lens_order
        self.lens_method = lens_method
        if noise_e_uk_arcmin is None:
            noise_e_uk_arcmin = np.sqrt(2.0) * noise_uk_arcmin
        if noise_b_uk_arcmin is None:
            noise_b_uk_arcmin = noise_e_uk_arcmin
        lmax = int(geom.lmax()) + 1
        ells = np.arange(lmax)
        ncomp = 3 if pol else 1
        ps_cmb = np.zeros((ncomp, ncomp, lmax))
        ps_cmb[0, 0] = np.asarray(theory.uCl("TT", ells))
        if pol:
            ps_cmb[1, 1] = np.asarray(theory.uCl("EE", ells))
            ps_cmb[2, 2] = np.asarray(theory.uCl("BB", ells))
            te = np.asarray(theory.uCl("TE", ells))
            ps_cmb[0, 1] = ps_cmb[1, 0] = te
        self.mgen = _grf.MapGen(geom, ps_cmb, dtype=dtype)
        ps_kk = np.asarray(theory.gCl("kk", ells))[None, None]
        self.kgen = _grf.MapGen(geom, ps_kk, dtype=dtype)
        self.kbeam = F.gauss_beam(geom.modlmap(dtype), beam_arcmin)
        ps_noise = np.zeros((ncomp, ncomp, lmax))
        ps_noise[0, 0] = (noise_uk_arcmin * arcmin) ** 2
        if pol:
            ps_noise[1, 1] = (noise_e_uk_arcmin * arcmin) ** 2
            ps_noise[2, 2] = (noise_b_uk_arcmin * arcmin) ** 2
        self.ngen = _grf.MapGen(geom, ps_noise, dtype=dtype)

    def get_unlensed(self, key):
        return self.mgen.get_map(key)

    def get_kappa(self, key):
        return self.kgen.get_map(key)

    def lens(self, unlensed, kappa):
        alpha = alpha_from_kappa(kappa, self.geom)
        if self.lens_method == "taylens":
            return taylens(unlensed, alpha, self.geom, order=self.lens_order)
        return lens_map_spline(unlensed, alpha, self.geom, order=self.lens_order)

    def get_sim(self, key, return_intermediate: bool = False,
                skip_lensing: bool = False):
        kc, kk, kn = jax.random.split(key, 3)
        unlensed = self.get_unlensed(kc)
        if skip_lensing:
            kappa = jnp.zeros(self.geom.shape, unlensed.dtype)
            lensed = unlensed
        else:
            kappa = self.get_kappa(kk)
            lensed = self.lens(unlensed, kappa)
        beamed = F.kfilter(lensed, self.kbeam, self.geom)
        noise = self.ngen.get_map(kn)
        observed = beamed + noise
        if return_intermediate:
            return observed, dict(unlensed=unlensed, kappa=kappa, lensed=lensed,
                                  beamed=beamed, noise=noise)
        return observed


# ------------------------------------------------------------------
# NFW halo profiles (reference lensing.py:701-770, 909-956)
# ------------------------------------------------------------------

def gnfw(x):
    """Projected NFW profile shape g(theta/thetaS) (Hu, DeDeo & Vale 2007;
    reference ``lensing.py:701``)."""
    x = jnp.asarray(x)
    xm1 = x * x - 1.0
    # x > 1 branch
    hi = (1.0 - 2.0 / jnp.sqrt(jnp.abs(xm1))
          * jnp.arctan(jnp.sqrt(jnp.abs((x - 1.0) / (x + 1.0))))) / jnp.where(
              jnp.abs(xm1) < 1e-12, 1.0, xm1)
    lo = (1.0 - 2.0 / jnp.sqrt(jnp.abs(xm1))
          * jnp.arctanh(jnp.sqrt(jnp.abs((1.0 - x) / (x + 1.0))))) / jnp.where(
              jnp.abs(xm1) < 1e-12, 1.0, xm1)
    out = jnp.where(x > 1.0, hi, lo)
    return jnp.where(jnp.abs(x - 1.0) < 1e-6, 1.0 / 3.0, out)


def f_c(c):
    return jnp.log(1.0 + c) - c / (1.0 + c)


def fnfw(x):
    return 1.0 / (x * (1.0 + x) ** 2)


G_MPC_S_MSUN = 4.517e-48   # Newton G in Mpc^3 / Msun / s^2
C_MPC_S = 9.716e-15        # speed of light in Mpc/s
TWO_G_OVER_C2 = 9.571e-20  # 2 G / c^2 in Mpc / Msun


def rho_nfw(M, c, R):
    """NFW 3D density (Msun/Mpc^3) as a function of radius r (Mpc)."""
    return lambda r: (c / R) ** 3 * M / (4.0 * np.pi * f_c(c)) * fnfw(c * r / R)


def proj_rho_nfw(theta, comL, M, c, R):
    """LOS-projected NFW density (Msun/Mpc^2) vs angle theta (radians)."""
    thetaS = R / c / comL
    return (c / R) ** 2 * M / (4.0 * np.pi * f_c(c)) * 2.0 * gnfw(theta / thetaS)


def projected_rho(thetas, comL, rho_func, pmax=2000.0, nps=500000):
    """Generic LOS projection of a 3D density profile by quadrature
    (reference ``lensing.py:924``)."""
    pz = jnp.linspace(-pmax, pmax, nps)
    th = jnp.atleast_1d(jnp.asarray(thetas))
    def one(theta):
        return jnp.trapezoid(rho_func(jnp.sqrt(pz ** 2 + (theta * comL) ** 2)), pz)
    return jax.lax.map(one, th)


def kappa_nfw_generic(theta, z, comL, M, c, R, win_at_lens):
    """NFW convergence profile vs angle (reference ``lensing.py:933``)."""
    return (4.0 * np.pi * G_MPC_S_MSUN * (1 + z) * comL * win_at_lens
            * proj_rho_nfw(theta, comL, M, c, R) / C_MPC_S ** 2)


def kappa_generic(theta, z, comL, rho_func, win_at_lens, pmax=2000.0, nps=500000):
    return (4.0 * np.pi * G_MPC_S_MSUN * (1 + z) * comL * win_at_lens
            * projected_rho(theta, comL, rho_func, pmax, nps) / C_MPC_S ** 2)


def nfw_kappa_profile(modrmap, mass_msun_overh, comL_mpc_overh, win_at_lens,
                      z_lens, concentration=3.2, rdel_mpc_overh=None,
                      overdensity=180.0, rho_mean_z=None):
    """NFW kappa on a radial grid, in the closed form of reference
    ``NFWkappa`` (``lensing.py:723``):

      kappa(theta) = (2G/c^2) * comL (1+z) W * M/(rS^2 f_c) * g(theta/thetaS)

    ``rdel_mpc_overh``: the overdensity radius R_delta in Mpc/h; if None it
    is computed from ``rho_mean_z`` (mean matter density at the relevant z
    in (Msun/h)/(Mpc/h)^3) via M = (4/3) pi delta rho R^3.
    """
    M = jnp.abs(mass_msun_overh)
    if rdel_mpc_overh is None:
        if rho_mean_z is None:
            raise ValueError("need rdel_mpc_overh or rho_mean_z")
        rdel_mpc_overh = (3.0 * M / (4.0 * np.pi * overdensity * rho_mean_z)) ** (1.0 / 3.0)
    c = concentration
    rS = rdel_mpc_overh / c
    thetaS = rS / comL_mpc_overh
    consts = (TWO_G_OVER_C2 * comL_mpc_overh * (1.0 + z_lens) * win_at_lens
              * M / (rS * rS) / f_c(c))
    sgn = jnp.sign(mass_msun_overh)
    return sgn * consts * gnfw(modrmap / thetaS)


# ------------------------------------------------------------------
# small utilities (reference lensing.py:669-697)
# ------------------------------------------------------------------

def fill_low_ell(ells, cls, ellmin):
    """Extend a spectrum to l=2 with its value at ellmin (host-side)."""
    ells = np.asarray(ells)
    cls = np.asarray(cls)
    low = np.where(ells > ellmin)[0][0]
    fill = np.arange(2, ells[low])
    return (np.concatenate([fill, ells[low:]]),
            np.concatenate([np.full(len(fill), cls[low]), cls[low:]]))


def sanitize_power(nl):
    """Replace negative values by NaN then interpolate over them
    (reference ``sanitizePower``)."""
    nl = np.asarray(nl, dtype=np.float64).copy()
    nl[nl < 0] = np.nan
    bad = np.isnan(nl)
    if bad.any():
        nl[bad] = np.interp(np.flatnonzero(bad), np.flatnonzero(~bad), nl[~bad])
    return nl


def validate_geometry(geom: Geometry, verbose: bool = False):
    """Sanity-check a geometry's area and pixel size, warning on
    pathological values (reference ``orphics/lensing.py:264``)."""
    import warnings
    area_sqdeg = float(geom.area) * (180.0 / np.pi) ** 2
    if verbose:
        print("Geometry area : ", area_sqdeg, " sq.deg.")
    if area_sqdeg > 41252.0:
        warnings.warn(f"Geometry has area larger than full-sky: {geom}")
    if area_sqdeg < (1.0 / 60.0 / 60.0):
        warnings.warn(f"Geometry has area less than 1 arcmin^2: {geom}")
    res_deg = np.rad2deg(max(geom.dy, geom.dx))
    if verbose:
        print("Geometry pixel width : ", res_deg * 60.0, " arcmin.")
    if res_deg > 30.0:
        warnings.warn(f"Geometry has pixel larger than 30 degrees: {geom}")
    if res_deg < (1.0 / 60.0 / 60.0):
        warnings.warn(f"Geometry has pixel smaller than 1 arcsecond: {geom}")
