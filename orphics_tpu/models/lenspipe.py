"""Fused end-to-end lensed-sim -> observation -> QE reconstruction.

The honest "config 6" pipeline: everything the reference's
tt_verification loop does per Monte-Carlo iteration
(``orphics/lensing.py:458-516`` FlatLensingSims.get_sim +
``tutorials/tt_verification.ipynb`` cell 4 reconstruction), as one
jitted program:

  1. unlensed CMB GRF — synthesized *directly as B-spline coefficients*
     (the spline prefilter is a Fourier multiplier, so it rides the
     synthesis filter for free),
  2. kappa GRF -> phi -> deflection (half-plane multipliers + irfft2),
  3. spline displacement by a shared-index gather
     (:func:`orphics_tpu.models.lensing._eval_spline_coeffs`),
  4. beam and white noise applied in Fourier space (statistically
     identical to the reference's map-space noise add),
  5. beam deconvolution + fused half-plane TT quadratic estimator
     (:meth:`orphics_tpu.models.qe.QE.kappa_tt_rfft`),
  6. N_L^0-debiased binned auto + cross spectra against the input kappa.

Everything happens on the rfft half-plane; the only full maps that ever
exist are the coefficient map, the lensed map and the deflection.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import Geometry, arcmin
from ..ops import fourier as F
from ..ops.binning import RfftBin2D
from . import grf as _grf
from . import qe as _qe
from .lensing import _bspline_freq_response, _eval_spline_coeffs

__all__ = ["LensedQEPipeline"]


def _fphi(modl):
    """kappa -> phi multiplier 2/(l(l+1)) with the l < 2 modes cut."""
    denom = modl * (modl + 1.0)
    fphi = np.where(denom > 0, 2.0 / np.where(denom > 0, denom, 1.0),
                    0.0)
    return np.where(modl < 2.0, 0.0, fphi)


class LensedQEPipeline:
    """Batched lensed-sim + TT-QE reconstruction pipeline (see module
    docstring).  ``step(key, batch)`` returns the binned
    (cross, auto_in, auto_rec_debiased) spectra, ``(3, nbins)`` per sim.

    Parameters mirror the reference tt_verification setup: SO-like
    ``beam_arcmin``/``noise_uk_arcmin``, CMB multipole cuts
    ``xlmin/xlmax``, kappa cuts ``klmin/klmax``, bin ``edges``.
    """

    def __init__(self, geom: Geometry, theory, beam_arcmin=1.4,
                 noise_uk_arcmin=6.0, xlmin=100, xlmax=3000, klmin=40,
                 klmax=3000, edges=None, lens_order: int = 5,
                 dtype=jnp.float32):
        if lens_order not in (3, 5):
            raise ValueError("lens_order must be 3 or 5")
        self.geom = geom
        self.lens_order = lens_order
        ny, nx = geom.shape
        nxr = nx // 2 + 1
        lmax_grid = geom.ellmax_safe()
        ells = np.arange(theory.lpad + 1)

        # --- synthesis filters on the rfft half-plane
        cl_uu = np.asarray(theory.uCl("TT", ells))
        cl_kk = np.asarray(theory.gCl("kk", ells))
        csq_tt = _grf.covsqrt_half(geom, ells, cl_uu, dtype=dtype)
        csq_kk = _grf.covsqrt_half(geom, ells, cl_kk, dtype=dtype)
        # fold the exact B-spline prefilter into the CMB synthesis filter
        ry = _bspline_freq_response(ny, lens_order)
        rx = _bspline_freq_response(nx, lens_order)[:nxr]
        resp = jnp.asarray(ry[:, None] * rx[None, :], dtype)
        self.csq_coeff = csq_tt / resp
        self.csq_kk = csq_kk

        # kappa -> phi -> deflection multipliers (i l_i * 2/(l(l+1)))
        modl_h = np.asarray(geom.modlmap_r(jnp.float32), np.float64)
        lmap = np.asarray(geom.lmap(jnp.float32), np.float64)
        ly_h = lmap[0][:, :nxr]
        lx_h = lmap[1][:, :nxr]
        fphi = _fphi(modl_h)
        self.alpha_filt = jnp.asarray(np.stack(
            [1j * ly_h * fphi, 1j * lx_h * fphi]).astype(np.complex64))

        # --- observation model (beam + white noise, Fourier space)
        kbeam_np = np.exp(-((beam_arcmin * arcmin) ** 2) * modl_h ** 2
                          / (16.0 * np.log(2.0)))
        self.kbeam_h = jnp.asarray(kbeam_np.astype(np.float32))
        self.inv_beam_h = jnp.asarray(
            (1.0 / np.maximum(kbeam_np, 1e-8)).astype(np.float32))
        # flat white-noise covsqrt on the half-plane (python scalar; it
        # becomes a jit constant inside step)
        self.ncov_h = float((noise_uk_arcmin * arcmin)
                            * (float(geom.npix) / float(geom.area) ** 0.5))

        # --- estimator + binning
        ctot = _qe.lensing_noise_2d(geom, theory, beam_arcmin,
                                    noise_uk_arcmin, dtype=dtype)
        self.qe = _qe.QE(
            geom, theory, ctot,
            xmask=F.mask_kspace(geom, lmin=xlmin,
                                lmax=min(xlmax, lmax_grid - 1)),
            kmask=F.mask_kspace(geom, lmin=klmin,
                                lmax=min(klmax, lmax_grid * 0.8)),
            dtype=dtype)
        self.n0_h = self.qe.N_L_kk("TT")[:, :nxr]
        if edges is None:
            edges = np.arange(klmin, min(klmax, int(lmax_grid * 0.8)), 80.0)
        self.binner = RfftBin2D(geom, edges)
        self.norm = float(geom.area) / float(geom.npix) ** 2

    @partial(jax.jit, static_argnames=("self", "batch"))
    def step(self, key, batch: int):
        """Run ``batch`` independent sim+recon pipelines; returns the
        binned (cross, auto_in, auto_rec - N0) stack, (batch, 3, nbins)."""
        geom = self.geom
        keys = jax.random.split(key, (batch, 3))
        eta_c = jax.vmap(lambda k: _grf.rand_hermitian_half(k, geom))(
            keys[:, 0])
        eta_k = jax.vmap(lambda k: _grf.rand_hermitian_half(k, geom))(
            keys[:, 1])
        eta_n = jax.vmap(lambda k: _grf.rand_hermitian_half(k, geom))(
            keys[:, 2])

        coeffs = F.irfft2(self.csq_coeff * eta_c, geom)   # spline coeffs
        kin_h = self.csq_kk * eta_k                        # input kappa
        alpha = F.irfft2(self.alpha_filt[None] * kin_h[:, None], geom)

        # coeffs are already prefiltered: evaluate the spline directly
        lensed = jax.vmap(
            lambda cc, aa: _eval_spline_coeffs(
                cc, aa, geom, self.lens_order))(coeffs, alpha)

        kobs_h = (self.kbeam_h * F.rfft2(lensed, geom)
                  + self.ncov_h * eta_n)
        xh = kobs_h * self.inv_beam_h                      # deconvolved
        fk = self.qe.kappa_tt_rfft(xh)

        cross = (fk.conj() * kin_h).real * self.norm
        auto_in = (kin_h.conj() * kin_h).real * self.norm
        auto_rec = (fk.conj() * fk).real * self.norm - self.n0_h[None]
        _, binned = self.binner.bin(
            jnp.stack([cross, auto_in, auto_rec], axis=1))
        return binned

    def centers(self):
        return self.binner.centers
