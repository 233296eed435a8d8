"""Flat-sky quadratic lensing estimators, normalization, and N_L^0.

The reference delegates its QE to the external ``symlens`` package
(README.md:20); its tutorials use ``qest.kappa_from_map("TT"|"EB", ...)``
and ``NlGenerator.updateNoise/getNls`` (tt_verification.ipynb cell 4,
Lensing-noise-curves.ipynb cell 4; ``lensing.py:973-976``). This module
re-derives those capabilities natively from the Hu & Okamoto (2002)
flat-sky forms: every estimator is a handful of elementwise products and
2D FFTs (mode-coupling integrals evaluated as FFT convolutions), so the
whole reconstruction jit-compiles into one fused XLA program. There is no
matrix product anywhere in it, so its float32 arithmetic is exact fp32
elementwise math and fp32 FFTs on every backend (no TF32 rounding).

Conventions
-----------
Internally spectra and fields live in "physical" Fourier units where
``<|T(l)|^2> = C_l``:  ``T_phys = fft_raw * sqrt(area)/npix``. The
mode-coupling integral is

  integral d^2 l1/(2pi)^2 A(l1) B(L-l1)
      = (npix/area) * fft_raw[ ifft_raw(A) * ifft_raw(B) ](L).

Estimators (f couplings, Hu & Okamoto 2002 Table 1):
  TT: f = C^TT(l1) (L.l1) + C^TT(l2) (L.l2)
  TE: f = C^TE(l1) cos(2 dphi) (L.l1) + C^TE(l2) (L.l2)
  TB: f = C^TE(l1) sin(2 dphi) (L.l1)
  EE: f = [C^EE(l1) (L.l1) + C^EE(l2) (L.l2)] cos(2 dphi)
  EB: f = [C^EE(l1) (L.l1) - C^BB(l2) (L.l2)] sin(2 dphi)
with dphi = phi_l1 - phi_l2, separated via
  cos 2phi = (lx^2 - ly^2)/l^2,  sin 2phi = 2 lx ly / l^2.

Weights F = f / (2 C1tot C2tot) for same-field (TT, EE) and
F = f / (C1tot C2tot) for cross-field (TE, TB, EB) — the standard
"Hu-DeDeo-Vale"-simplified filters (also symlens' default family).

Normalization: phi_hat = A_L * integral F T T with
A_L = [ integral f F ]^(-1); then N^0,phiphi = A_L and
kappa = (L^2/2) phi, N^0,kappakappa = (L^4/4) A_L.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import Geometry, arcmin
from ..ops import fourier as F
from ..ops.binning import Bin2D

__all__ = ["QE", "NlGenerator", "lensing_noise_2d", "rdn0", "mcn0",
           "n1_tt"]

ESTIMATORS = ("TT", "TE", "EE", "EB", "TB")
LEG_FIELDS = {"TT": ("T", "T"), "TE": ("T", "E"), "EE": ("E", "E"),
              "EB": ("E", "B"), "TB": ("T", "B")}


def _ifft(a):
    return jnp.fft.ifft2(a, axes=(-2, -1))


def _fft(a):
    return jnp.fft.fft2(a, axes=(-2, -1))


class QE:
    """Quadratic estimator engine for one (geometry, theory, noise) config.

    Lifetime note: the reconstruction methods are jitted with ``self``
    static, so every instance whose methods were called under jit is
    retained by jax's global jit cache (with its cached A_L/N0/plan
    grids). Long parameter scans that construct many engines should
    call ``jax.clear_caches()`` between configs to release them.

    Parameters
    ----------
    geom : Geometry
    theory : TheorySpectra (lensed spectra are used in the couplings)
    ctot2d : dict mapping 'TT'/'EE'/'BB' to total (signal+noise) 2D spectra
        of the *beam-deconvolved* input maps. Build from noise levels with
        :func:`lensing_noise_2d`.
    xmask, ymask : 2D Fourier masks applied to the input legs (CMB
        multipole cuts); kmask : mask on the output L plane.
    field_masks : optional dict {'T': mask, 'E': mask, 'B': mask} of
        PER-FIELD leg masks (the cross-N0 machinery uses these so a
        T leg and a P leg carry their own cuts). MUTUALLY EXCLUSIVE
        with xmask/ymask/grad_cut: when given, it replaces all three
        for every estimator (a ValueError guards the combination).
    """

    def __init__(self, geom: Geometry, theory, ctot2d: Dict[str, jnp.ndarray],
                 xmask=None, ymask=None, kmask=None, dtype=jnp.float32,
                 grad_cut: Optional[float] = None, te_filter: str = "hu_ok",
                 te_series_order: int = 4, field_masks=None):
        self.geom = geom
        self.dtype = dtype
        self.te_filter = te_filter
        self.te_series_order = int(te_series_order)
        if field_masks is not None and (
                xmask is not None or ymask is not None
                or grad_cut is not None):
            raise ValueError(
                "field_masks replaces xmask/ymask/grad_cut entirely — "
                "pass one or the other, not both (the leg cuts you "
                "passed would be silently ignored otherwise)")
        self.field_masks = None if field_masks is None else {
            k: jnp.asarray(v, dtype) for k, v in field_masks.items()}
        modlmap = geom.modlmap_np()
        ells = np.arange(theory.lpad + 1)
        self.cl2d = {}
        for spec in ("TT", "EE", "BB", "TE"):
            cl = np.asarray(theory.lCl(spec, ells), dtype=np.float64)
            self.cl2d[spec] = jnp.asarray(
                np.interp(np.asarray(modlmap), ells, cl, left=0, right=0),
                dtype=dtype)
        one = jnp.ones(geom.shape, dtype)
        self.xmask = one if xmask is None else jnp.asarray(xmask, dtype)
        self.ymask = self.xmask if ymask is None else jnp.asarray(ymask, dtype)
        self.kmask = one if kmask is None else jnp.asarray(kmask, dtype)
        if grad_cut is not None:
            self.gmask = self.xmask * (geom.modlmap(dtype) <= grad_cut)
        else:
            self.gmask = self.xmask
        self.ctot = {k: jnp.asarray(v, dtype) for k, v in ctot2d.items()}
        lmap = geom.lmap(dtype)
        self.ly, self.lx = lmap[0], lmap[1]
        ml = geom.modlmap(dtype)
        self.modlmap = ml
        safe = jnp.where(ml > 0, ml, 1.0)
        self.cos2phi = jnp.where(ml > 0, (self.lx ** 2 - self.ly ** 2) / safe ** 2, 0.0)
        self.sin2phi = jnp.where(ml > 0, 2.0 * self.lx * self.ly / safe ** 2, 0.0)
        self._phys = float(geom.area) ** 0.5 / geom.npix
        self._conv_fac = geom.npix / float(geom.area)
        self._al_cache = {}

    # -- mode-coupling integral ---------------------------------------
    def _conv(self, A, B):
        """integral d^2l1/(2pi)^2 A(l1) B(L - l1) on the grid."""
        return _fft(_ifft(A) * _ifft(B)) * self._conv_fac

    # -- normalization -------------------------------------------------
    def A_L(self, est: str):
        """2D phi normalization A_L = [ integral f F ]^(-1) (cached).

        Computed under ``ensure_compile_time_eval`` so the cached grid is
        always concrete (it is a pure function of the static config) even
        when first requested inside a user's jit trace.
        """
        est = est.upper()
        if est not in self._al_cache:
            with jax.ensure_compile_time_eval():
                inv = self._fF_integral(est)
                # Zero/negative values occur only outside kmask support.
                al = jnp.where(jnp.abs(inv) > 1e-30, 1.0 / inv, 0.0).real
                self._al_cache[est] = al.astype(self.dtype)
        return self._al_cache[est]

    def N_L_kk(self, est: str):
        """2D Gaussian reconstruction noise N_L^0 for kappa.

        The true Gaussian disconnected noise (includes the swapped-leg
        contraction); for exact minimum-variance filters this equals
        (L^4/4) A_L, but it stays correct for simplified families
        (``te_filter='hdv'``) too."""
        return self.N_L_kk_cross(est, est)

    # ------------------------------------------------------------------
    # Separable-term algebra
    #
    # Every estimator coupling f and filter F is a sum of terms
    #   (dot_leg, ang, w1, w2):  (L . l_{dot_leg}) * ang(dphi)
    #                            * w1(l1) * w2(l2)
    # with ang in {'1','c','s'} = {1, cos 2(phi1-phi2), sin 2(phi1-phi2)}.
    # All integrals (normalization, auto- and cross-N0) and the
    # reconstruction itself are generic contractions of term lists via
    # FFT convolutions — this is what lets the full Hu-Okamoto TE filter
    # and the estimator cross-covariances come for free.
    # ------------------------------------------------------------------

    def _f_terms(self, est):
        """Lensing response coupling f (Hu & Okamoto 2002 Table 1)."""
        C = self.cl2d
        one = jnp.ones((), self.dtype)
        if est == "TT":
            return [(1, "1", C["TT"], one), (2, "1", one, C["TT"])]
        if est == "TE":
            return [(1, "c", C["TE"], one), (2, "1", one, C["TE"])]
        if est == "TB":
            return [(1, "s", C["TE"], one)]
        if est == "EE":
            return [(1, "c", C["EE"], one), (2, "c", one, C["EE"])]
        if est == "EB":
            return [(1, "s", C["EE"], one), (2, "s", one, -C["BB"])]
        raise ValueError(f"unknown estimator {est}")

    @staticmethod
    def _swap_terms(terms):
        """terms of F(l2, l1) given terms of F(l1, l2): swap legs;
        sin 2(phi2-phi1) = -sin 2(phi1-phi2)."""
        out = []
        for (d, a, w1, w2) in terms:
            w1n, w2n = w2, w1
            if a == "s":
                w1n = -w1n
            out.append((3 - d, a, w1n, w2n))
        return out

    @staticmethod
    def _scale_terms(terms, s1, s2):
        return [(d, a, w1 * s1, w2 * s2) for (d, a, w1, w2) in terms]

    def _filter_terms(self, est):
        """Estimator weights F as a term list.

        Same-field (TT, EE): F = f / (2 C1tot C2tot) — the exact minimum-
        variance filter. TB/EB: F = f/(C1tot C2tot), exact when the
        TB/EB total cross-spectra vanish. TE: the full Hu-Okamoto
        minimum-variance solution of the coupled (l1,l2)/(l2,l1) system,

          F(l1,l2) = [Ctt(l2) Cee(l1) f(l1,l2) - Cte(l1) Cte(l2) f(l2,l1)]
                     / [Ctt(l1)Cee(l2)Ctt(l2)Cee(l1) - (Cte(l1)Cte(l2))^2]

        with 1/(1-x) expanded in the separable x = r^2(l1) r^2(l2),
        r^2 = Cte^2/(Ctt Cee) (|x| < ~0.15, 4 orders => <1e-4), unless
        ``te_filter='hdv'`` requests the simplified f/(Ctt1 Cee2) family.
        Leg masks are folded into the weights.
        """
        est = est.upper()
        f1, f2 = LEG_FIELDS[est]
        if self.field_masks is not None:
            m1 = self.field_masks[f1]
            m2 = self.field_masks[f2]
        else:
            m1, m2 = self.gmask, self.ymask
        # zero-guarded inverse filters: ctot vanishes beyond the theory
        # table (interp right=0) and everywhere for noiseless configs —
        # the same guard the fused TT plans apply (an unguarded 0/0
        # would NaN-poison every L after the convolution)
        def _inv(ct):
            return jnp.where(ct > 0, 1.0 / jnp.where(ct > 0, ct, 1.0),
                             0.0)
        ct1 = self.ctot[f1 + f1]
        ct2 = self.ctot[f2 + f2]
        if est in ("TT", "EE"):
            norm = 2.0
        else:
            norm = 1.0
        if est != "TE" or self.te_filter == "hdv":
            return self._scale_terms(self._f_terms(est),
                                     m1 * _inv(norm * ct1),
                                     m2 * _inv(ct2))
        # full Hu-Okamoto TE
        ctt, cee, cte = self.ctot["TT"], self.ctot["EE"], self.cl2d["TE"]
        ictt, icee = _inv(ctt), _inv(cee)
        r2 = cte ** 2 * ictt * icee
        fterms = self._f_terms(est)
        fswap = self._swap_terms(fterms)
        out = []
        for k in range(self.te_series_order + 1):
            xk1 = r2 ** k
            xk2 = r2 ** k
            # + x^k f(l1,l2) / (Ctt1 Cee2)
            out += self._scale_terms(fterms, xk1 * m1 * ictt,
                                     xk2 * m2 * icee)
            # - x^k f(l2,l1) Cte1 Cte2 / (Ctt1 Cee1 Ctt2 Cee2)
            out += self._scale_terms(
                fswap, -xk1 * cte * ictt * icee * m1,
                xk2 * cte * ictt * icee * m2)
        return out

    def _angle_pairs(self, a):
        """Separable (u1, u2, coef) expansion of the angle factor."""
        c, s = self.cos2phi, self.sin2phi
        one = jnp.ones((), self.dtype)
        if a == "1":
            return [(one, one, 1.0)]
        if a == "c":
            return [(c, c, 1.0), (s, s, 1.0)]
        if a == "s":
            return [(s, c, 1.0), (c, s, -1.0)]
        raise ValueError(a)

    @staticmethod
    def _is_zero(w):
        try:
            return bool(np.all(np.asarray(w) == 0))
        except Exception:
            return False

    def _pair_integral(self, termsA, termsB):
        """integral d^2 l1/(2pi)^2 [termsA](l1, L-l1) [termsB](l1, L-l1)."""
        Li = (self.ly, self.lx)
        out = 0.0
        for (dA, aA, w1A, w2A) in termsA:
            if self._is_zero(w1A) or self._is_zero(w2A):
                continue
            for (dB, aB, w1B, w2B) in termsB:
                if self._is_zero(w1B) or self._is_zero(w2B):
                    continue
                for (u1a, u2a, ca) in self._angle_pairs(aA):
                    for (u1b, u2b, cb) in self._angle_pairs(aB):
                        W1 = w1A * w1B * u1a * u1b
                        W2 = w2A * w2B * u2a * u2b
                        coef = ca * cb
                        # hoist the iffts out of the (i, j) loop: this
                        # runs EAGERLY (ensure_compile_time_eval), so
                        # there is no XLA CSE to save us — the naive
                        # loop redoes identical full-grid transforms
                        # (thousands per HO-TE N0). Each leg carries at
                        # most one Li factor per side; precompute the
                        # three ifft variants per leg and combine.
                        i1, i2 = {}, {}
                        if dA == 2 and dB == 2:
                            i1[()] = _ifft(W1)
                        if dA == 1 and dB == 1:
                            i2[()] = _ifft(W2)
                        if dA != dB:
                            for i in range(2):
                                i1[(i,)] = _ifft(W1 * Li[i])
                                i2[(i,)] = _ifft(W2 * Li[i])
                        if dA == 1 and dB == 1:
                            for i in range(2):
                                for j in range(i, 2):
                                    sym = 1.0 if i == j else 2.0
                                    x1 = _ifft(W1 * Li[i] * Li[j])
                                    out = out + (sym * coef * Li[i]
                                                 * Li[j] * self._conv_fac) \
                                        * _fft(x1 * i2[()])
                        elif dA == 2 and dB == 2:
                            for i in range(2):
                                for j in range(i, 2):
                                    sym = 1.0 if i == j else 2.0
                                    x2 = _ifft(W2 * Li[i] * Li[j])
                                    out = out + (sym * coef * Li[i]
                                                 * Li[j] * self._conv_fac) \
                                        * _fft(i1[()] * x2)
                        else:
                            # one derivative on each leg: Li[i] on the
                            # dA side, Li[j] on the dB side
                            for i in range(2):
                                for j in range(2):
                                    a1 = i1[(i,)] if dA == 1 else i1[(j,)]
                                    a2 = i2[(i,)] if dA == 2 else i2[(j,)]
                                    out = out + (coef * Li[i] * Li[j]
                                                 * self._conv_fac) \
                                        * _fft(a1 * a2)
        return out

    def _fF_integral(self, est):
        """integral d^2 l1/(2pi)^2 f F (the inverse normalization)."""
        return self._pair_integral(self._f_terms(est),
                                   self._filter_terms(est))

    def _ctot_cross(self, fa, fb):
        """Total cross-spectrum of two fields (noise uncorrelated between
        T and E/B; TB and EB vanish for the fiducial)."""
        if fa == fb:
            return self.ctot[fa + fb]
        pair = "".join(sorted(fa + fb))
        if pair == "ET":
            return self.cl2d["TE"]
        return None  # TB, EB

    def N0_phi_cross(self, estA, estB):
        """Gaussian reconstruction-noise cross-spectrum N_L^{phi,AB}
        between two estimators (Hu-Okamoto 2002 eq. 17 generalized):

          N_AB = A_A A_B int F_A(l1,l2) [ F_B(l1,l2) Caa'(l1) Cbb'(l2)
                                    + F_B(l2,l1) Cab'(l1) Cba'(l2) ]

        For A == B with exact MV filters this reduces to A_L. Cached;
        concrete at trace time like A_L.
        """
        estA, estB = estA.upper(), estB.upper()
        # N_AB is symmetric in (A, B): one cache entry per pair
        key = ("n0",) + tuple(sorted((estA, estB)))
        if key not in self._al_cache:
            with jax.ensure_compile_time_eval():
                FA = self._filter_terms(estA)
                FB = self._filter_terms(estB)
                fa, fb = LEG_FIELDS[estA], LEG_FIELDS[estB]
                total = 0.0
                c11 = self._ctot_cross(fa[0], fb[0])
                c22 = self._ctot_cross(fa[1], fb[1])
                if c11 is not None and c22 is not None:
                    total = total + self._pair_integral(
                        FA, self._scale_terms(FB, c11, c22))
                c12 = self._ctot_cross(fa[0], fb[1])
                c21 = self._ctot_cross(fa[1], fb[0])
                if c12 is not None and c21 is not None:
                    total = total + self._pair_integral(
                        FA, self._scale_terms(self._swap_terms(FB),
                                              c12, c21))
                if isinstance(total, float):
                    n0 = jnp.zeros(self.geom.shape, self.dtype)
                else:
                    alA = self.A_L(estA)
                    alB = self.A_L(estB)
                    # A_L^2 alone underflows float32 (~1e-40 at
                    # L ~ 3000, and GPUs flush subnormals to zero):
                    # multiply the O(1/A) integral in first
                    n0 = ((alA * total.real) * alB).astype(self.dtype)
                self._al_cache[key] = n0 * self.kmask
        return self._al_cache[key]

    def N_L_kk_cross(self, estA, estB):
        """kappa-convention cross N0: (L^2/2)^2 N^{phi,AB}."""
        L = self.modlmap
        return (L ** 4 / 4.0) * self.N0_phi_cross(estA, estB)

    # -- reconstruction --------------------------------------------------
    def unnormalized_phi(self, est, kx, ky):
        """integral F X Y as FFT products; kx, ky are *raw* fft k-maps of
        the beam-deconvolved X and Y legs (per estimator: X in {T,E},
        Y in {T,E,B}). Generic over the filter term list.

        Note on the sin sign: our queb_rotmat angle convention
        (a = 2 atan2(-lx, ly), the enmap/healpix one) flips sin(2 dphi)
        relative to the Hu-Okamoto phi_l = atan2(ly, lx) convention, so
        every linear appearance of sin 2(phi1-phi2) in the reconstruction
        carries an extra -1 (validated end-to-end by the EB Monte-Carlo
        cross-ratio test). Quadratic appearances (the A_L / N0 integrals)
        are insensitive.
        """
        est = est.upper()
        X = kx * self._phys
        Y = ky * self._phys
        Li = (self.ly, self.lx)
        out = 0.0
        for (d, a, w1, w2) in self._filter_terms(est):
            if self._is_zero(w1) or self._is_zero(w2):
                continue
            for (u1, u2, c) in self._angle_pairs(a):
                if a == "s":
                    c = -c  # convention flip, see docstring
                A1 = u1 * w1 * X
                A2 = u2 * w2 * Y
                for i in range(2):
                    B1, B2 = A1, A2
                    if d == 1:
                        B1 = B1 * Li[i]
                    else:
                        B2 = B2 * Li[i]
                    out = out + (c * Li[i]) * self._conv(B1, B2)
        return out

    @partial(jax.jit, static_argnames=("self", "est", "return_ft"))
    def kappa_from_map(self, est, kx, ky=None, return_ft: bool = True):
        """Reconstruct kappa from raw-fft k-map legs.

        The reference-tutorials' ``qest.kappa_from_map("TT", kmap,
        alreadyFTed=True, returnFt=True)`` surface. Returns the raw-fft
        kappa (or the real map with ``return_ft=False``).
        """
        if ky is None:
            ky = kx
        uphi = self.unnormalized_phi(est, kx, ky)
        # "phys" fields are continuum/sqrt(area) (so <|T|^2> = C_l with a
        # Kronecker delta); the quadratic integral therefore carries one
        # residual 1/sqrt(area) that must be restored for the response to
        # the true phi to equal 1/A_L.
        phi = self.A_L(est) * uphi * self.kmask * (float(self.geom.area) ** 0.5)
        fkappa_phys = 0.5 * self.modlmap ** 2 * phi
        fkappa_raw = fkappa_phys / self._phys
        if return_ft:
            return fkappa_raw
        return _ifft(fkappa_raw).real

    # -- fused half-plane TT path ----------------------------------------
    def _tt_half_plans(self):
        """Precompute the rfft half-plane filter arrays for the fused TT
        reconstruction (cached; pure functions of the static config).

        Exploits that for a *real* observed map the raw-fft k-map X is
        Hermitian, so every intermediate real-space leg of the TT estimator

          uphi(L) = sum_i L_i cf FFT[ ifft(l_i C w1 X) ifft(w2 Y)
                                      + ifft(w1 X) ifft(l_i C w2 Y) ](L)

        is a real field: the whole reconstruction runs on the rfft
        half-plane (irfft2/rfft2), halving every transform. The gradient
        legs ifft(l_i C w X) are purely imaginary (odd x Hermitian), so we
        fold a ``-1j`` into the half-plane filter to make them real.
        """
        if "_tt_half" in self._al_cache:
            return self._al_cache["_tt_half"]
        with jax.ensure_compile_time_eval():
            nxr = self.geom.nx // 2 + 1
            half = lambda A: jnp.asarray(A)[..., :nxr]
            C = self.cl2d["TT"]
            ct = self.ctot["TT"]
            if self.field_masks is not None:
                m1 = m2 = self.field_masks["T"]
            else:
                m1, m2 = self.gmask, self.ymask
            sym = bool(np.array_equal(np.asarray(m1), np.asarray(m2)))
            phys = jnp.asarray(self._phys, self.dtype)
            w1 = jnp.where(ct > 0, m1 / (2.0 * jnp.where(ct > 0, ct, 1.0)), 0.0)
            w2 = jnp.where(ct > 0, m2 / jnp.where(ct > 0, ct, 1.0), 0.0)
            # All plan arrays stay real; the -1j that turns the
            # anti-Hermitian gradient leg Hermitian is applied to the
            # traced input instead.
            # zero the gradient leg on the Nyquist row/column: there
            # the leg is self-conjugate (real), so the -1j Hermitian
            # fold below would mis-decompose it — with the zeroing the
            # fused identity vs kappa_from_map holds for ANY leg mask
            # (incl. the default all-ones), at the cost of modes any
            # sane xmask excludes anyway
            nyq = np.ones(self.geom.shape, np.float32)
            nyq[self.geom.ny // 2, :] = 0.0
            nyq[:, self.geom.nx // 2] = 0.0
            nyq = jnp.asarray(nyq)
            wa0 = half(w1 * phys)
            wag = jnp.stack([half(self.ly * C * w1 * nyq * phys),
                             half(self.lx * C * w1 * nyq * phys)])
            if sym:
                wb0 = wbg = None
            else:
                wb0 = half(w2 * phys)
                wbg = jnp.stack([half(self.ly * C * w2 * nyq * phys),
                                 half(self.lx * C * w2 * nyq * phys)])
            L2 = self.modlmap ** 2
            post = half(self.A_L("TT") * self.kmask * 0.5 * L2
                        * (float(self.geom.area) ** 0.5 / self._phys)
                        * self._conv_fac)
            Lh = jnp.stack([half(self.ly), half(self.lx)])
            plans = (wa0, wag, wb0, wbg, post.astype(self.dtype), Lh, sym)
            self._al_cache["_tt_half"] = plans
        return plans

    @partial(jax.jit, static_argnames=("self",))
    def kappa_tt_rfft(self, xh, yh=None):
        """Fused TT kappa reconstruction on the rfft half-plane.

        ``xh`` (and optional second leg ``yh``): raw ``rfft2`` k-maps of the
        *real* beam-deconvolved observed map(s), shape (..., ny, nx//2+1).
        Returns the raw-fft half-plane kappa — ``kappa_from_map("TT",
        fft2(map))[..., :nx//2+1]`` to fp32 accuracy at ~5 half-plane
        transforms per map instead of ~12 full-plane ones. Power spectra of
        the output bin exactly with :class:`~orphics_tpu.ops.binning.RfftBin2D`.

        On the Nyquist row/column the gradient leg ``l_i C X`` is
        self-conjugate (real), so its ``-1j`` fold has no valid
        decomposition — the plan builders therefore ZERO the gradient
        filter there. With leg masks whose ``lmax`` is strictly below
        the grid Nyquist modulus (every production cut), this is a
        no-op and the fused path is bit-identical to
        ``kappa_from_map("TT", ...)``; with masks touching Nyquist
        (e.g. the default all-ones), the fused estimator is
        well-defined but EXCLUDES those self-conjugate gradient modes,
        which the generic full-plane path includes.
        """
        geom = self.geom
        wa0, wag, wb0, wbg, post, Lh, sym = self._tt_half_plans()
        if yh is None:
            yh = xh
        same = yh is xh
        xg = -1j * xh  # makes the anti-Hermitian gradient legs Hermitian
        a = F.irfft2(wa0 * xh, geom)
        alpha = F.irfft2(wag * xg[..., None, :, :], geom)  # (..., 2, ny, nx)
        if sym and same:
            S = 4.0 * a[..., None, :, :] * alpha
        else:
            yg = -1j * yh
            if sym:
                b = 2.0 * F.irfft2(wa0 * yh, geom)
                beta = 2.0 * F.irfft2(wag * yg[..., None, :, :], geom)
            else:
                b = F.irfft2(wb0 * yh, geom)
                beta = F.irfft2(wbg * yg[..., None, :, :], geom)
            S = alpha * b[..., None, :, :] + a[..., None, :, :] * beta
        Sk = F.rfft2(S, geom)
        uphi = 1j * (Lh[0] * Sk[..., 0, :, :] + Lh[1] * Sk[..., 1, :, :])
        return post * uphi


def lensing_noise_2d(geom: Geometry, theory, beam_arcmin, noise_t_uk_arcmin,
                     noise_p_uk_arcmin=None, dtype=jnp.float32):
    """Total 2D spectra of beam-deconvolved maps: C_l + N_l / b_l^2.

    The standard inputs to :class:`QE` (reference tutorials build exactly
    this: ``noise2d = (noise*arcmin)^2 / gauss_beam(modlmap, beam)**2``).
    """
    if noise_p_uk_arcmin is None:
        noise_p_uk_arcmin = np.sqrt(2.0) * noise_t_uk_arcmin
    modlmap = geom.modlmap_np()
    ells = np.arange(theory.lpad + 1)
    b2 = np.asarray(F.gauss_beam(modlmap, beam_arcmin)) ** 2
    out = {}
    for spec, noise in (("TT", noise_t_uk_arcmin), ("EE", noise_p_uk_arcmin),
                        ("BB", noise_p_uk_arcmin)):
        cl = np.interp(np.asarray(modlmap), ells,
                       np.asarray(theory.lCl(spec, ells)), left=0, right=0)
        n2d = (noise * arcmin) ** 2 / np.maximum(b2, 1e-30)
        out[spec] = jnp.asarray(cl + n2d, dtype)
    return out


class NlGenerator:
    """Binned N_L^0 curves for instrument configs (the reference-tutorial
    ``NlGenerator(shape,wcs,theory,bin_edges)`` surface)."""

    def __init__(self, geom: Geometry, theory, bin_edges, dtype=jnp.float32):
        self.geom = geom
        self.theory = theory
        self.binner = Bin2D(geom.modlmap_np(), bin_edges)
        self.dtype = dtype
        self._qe = None

    def update_noise(self, beam_arcmin, noise_t_uk_arcmin,
                     noise_p_uk_arcmin=None, tellmin=30, tellmax=3000,
                     pellmin=30, pellmax=5000, kmin=10, kmax=None):
        ctot = lensing_noise_2d(self.geom, self.theory, beam_arcmin,
                                noise_t_uk_arcmin, noise_p_uk_arcmin,
                                self.dtype)
        xt = F.mask_kspace(self.geom, lmin=tellmin, lmax=tellmax)
        kmask = F.mask_kspace(self.geom, lmin=kmin, lmax=kmax)
        xp = F.mask_kspace(self.geom, lmin=pellmin, lmax=pellmax)
        # one engine with per-field multipole masks: cross-N0 between a
        # T-leg and a P-leg estimator then carries each field's own cuts
        qe = QE(self.geom, self.theory, ctot, kmask=kmask, dtype=self.dtype,
                field_masks={"T": xt, "E": xp, "B": xp})
        self._qe = qe
        return self

    updateNoise = update_noise

    def _engine(self):
        if self._qe is None:
            raise RuntimeError("call update_noise(...) before querying "
                               "NlGenerator noise curves")
        return self._qe

    def get_nl(self, est="TT"):
        est = est.upper()
        n2d = self._engine().N_L_kk(est)
        cents, n1d = self.binner.bin(n2d)
        return cents, np.asarray(n1d)

    getNl = get_nl

    def get_nl_cross(self, estA, estB):
        """Binned cross-N0 between two estimators (kappa convention)."""
        cents, n1d = self.binner.bin(
            self._engine().N_L_kk_cross(estA.upper(), estB.upper()))
        return cents, np.asarray(n1d)

    def get_nl_matrix(self, ests=("TT", "TE", "EE", "EB", "TB")):
        """Binned N0 covariance matrix between estimators, shape
        (nest, nest, nbins). Off-diagonals vanish for pairs that share
        no total cross-spectrum (e.g. TTxEB)."""
        ests = [e.upper() for e in ests]
        n = len(ests)
        qe = self._engine()
        cents = None
        mat = None
        for i in range(n):
            for j in range(i, n):
                cents, nij = self.binner.bin(
                    qe.N_L_kk_cross(ests[i], ests[j]))
                if mat is None:
                    mat = np.zeros((n, n, len(np.asarray(cents))))
                mat[i, j] = mat[j, i] = np.asarray(nij)
        return np.asarray(cents), mat

    def get_nl_mv(self, ests=("TT", "TE", "EE", "EB", "TB"),
                  naive=False):
        """Minimum-variance N_L^kk over estimators.

        Full combination: N_mv(L) = 1 / sum_ij [N^-1(L)]_ij with N the
        per-bin estimator covariance including cross-N0 terms (the
        reference/symlens full-covariance combination; round-1's naive
        1/N = sum 1/N_i is kept behind ``naive=True``).
        """
        if naive:
            invs = []
            for est in ests:
                n2d = np.asarray(self._engine().N_L_kk(est),
                                 dtype=np.float64)
                invs.append(1.0 / np.where(n2d > 0, n2d, np.inf))
            tot = np.sum(invs, axis=0)
            n_mv = 1.0 / np.where(tot > 0, tot, np.inf)
            cents, n1d = self.binner.bin(jnp.asarray(n_mv))
            return cents, np.asarray(n1d)
        cents, mat = self.get_nl_matrix(ests)
        nb = mat.shape[-1]
        # unusable bins are INFINITE noise (matching the naive branch);
        # 0 would read as infinite signal-to-noise downstream
        out = np.full(nb, np.inf)
        for b in range(nb):
            N = mat[:, :, b]
            good = np.diag(N) > 0
            if not np.any(good):
                continue
            Ng = N[np.ix_(good, good)]
            try:
                inv = np.linalg.inv(Ng)
            except np.linalg.LinAlgError:
                inv = np.linalg.pinv(Ng)
            s = inv.sum()
            out[b] = 1.0 / s if s > 0 else np.inf
        return cents, out


# ---------------------------------------------------------------------
# Realization-dependent N0 (RDN0) and Monte-Carlo N0 (MCN0)
# ---------------------------------------------------------------------

def _kk_cl_fn(qe: "QE", bin_edges):
    """Binned kappa cross-power of two raw-fft kappa maps."""
    from ..ops.binning import Bin2D
    binner = Bin2D(qe.geom.modlmap_np(), np.asarray(bin_edges, float))
    norm = jnp.asarray(float(qe.geom.area) / float(qe.geom.npix) ** 2,
                       jnp.float32)

    def cl(A, B):
        return binner.bin((A.conj() * B).real * norm)[1]

    return binner, cl


def rdn0(qe: "QE", est: str, kdata, sim_kmaps, bin_edges,
         pair_shift: int = 1):
    """Realization-dependent N0 debias for the quadratic estimator —
    the data-anchored Gaussian-noise estimate of Planck 2015 XV eq. 16
    (quicklens/plancklens ``n0s.rdn0``), in kappa convention:

      RDN0(L) = < Cl(Q[d,s], Q[d,s]) + Cl(Q[d,s], Q[s,d])
                 + Cl(Q[s,d], Q[d,s]) + Cl(Q[s,d], Q[s,d])
                 - Cl(Q[s,s'], Q[s,s']) - Cl(Q[s,s'], Q[s',s]) >_s

    with d the (beam-deconvolved, raw-fft) data leg, s/s' independent
    Gaussian sims of the data covariance, and Q[a,b] the normalized
    two-leg kappa estimator. Being linear in the data power, RDN0
    absorbs the mismatch between the fiducial and true spectra to
    first order — the step beyond the analytic ``QE.N_L_kk`` that the
    reference ecosystem's tutorials stop at.

    The whole sim loop runs as ONE jitted ``lax.map`` over the sim
    batch (each iteration is 4 two-leg reconstructions); sims are
    paired cyclically (``s'_i = s_{i+pair_shift}``).

    Parameters
    ----------
    kdata : (ny, nx) complex raw-fft data leg (beam-deconvolved).
    sim_kmaps : (nsims, ny, nx) complex raw-fft sim legs drawn from the
        same total covariance as the data (signal + noise, beam-
        deconvolved) — e.g. ``jnp.fft.fft2(fls.get_sim(keys)) / kbeam``.
    bin_edges : 1D array of L-bin edges.

    Returns
    -------
    (centers, rdn0_kk, mcn0_kk) : binned curves; ``mcn0_kk`` is the
        pure sim-pair Monte-Carlo N0 (the last two terms alone).
    """
    est = est.upper()
    sim_kmaps = jnp.asarray(sim_kmaps)
    nsims = sim_kmaps.shape[0]
    if nsims < 2:
        raise ValueError("rdn0 needs >= 2 sims for the s-s' pairs")
    binner, cl = _kk_cl_fn(qe, bin_edges)
    kdata = jnp.asarray(kdata)
    shift = int(pair_shift) % nsims

    @jax.jit
    def run(kd, sims):
        sims2 = jnp.roll(sims, -shift, axis=0)

        def one(pair):
            s, s2 = pair
            qds = qe.kappa_from_map(est, kd, s)
            qsd = qe.kappa_from_map(est, s, kd)
            qss = qe.kappa_from_map(est, s, s2)
            qs2s = qe.kappa_from_map(est, s2, s)
            t_data = (cl(qds, qds) + cl(qds, qsd)
                      + cl(qsd, qds) + cl(qsd, qsd))
            t_mc = cl(qss, qss) + cl(qss, qs2s)
            return t_data, t_mc

        t_data, t_mc = jax.lax.map(one, (sims, sims2))
        return t_data.mean(axis=0), t_mc.mean(axis=0)

    t_data, t_mc = run(kdata, sim_kmaps)
    cents = binner.centers
    return cents, np.asarray(t_data - t_mc), np.asarray(t_mc)


def _iso_profile(geom, grid2d):
    """(l, value) samples of an isotropic 2D Fourier grid, taken along
    its ly=0 row — exact whenever the grid is a function of modlmap
    (interpolated 1D spectra, annulus masks, A_L for isotropic
    filters). Sorted and deduped for ``jnp.interp``."""
    ml = np.asarray(geom.modlmap_np())[0]
    vals = np.asarray(grid2d)[0]
    order = np.argsort(ml, kind="stable")
    lu, idx = np.unique(ml[order], return_index=True)
    return lu, vals[order][idx]


def _embed_pad(P, pad):
    """Zero-embed FFT-ordered l-lattice grids into a ``pad``-times finer
    Brillouin zone (same dl, pad*Nyquist): fftshift -> symmetric zero
    pad -> ifftshift. Every original lattice point keeps its frequency,
    so transforms on the embedded lattice are EXACT continuations."""
    if pad == 1:
        return P
    ny, nx = P.shape[-2:]
    wy = (ny * (pad - 1)) // 2
    wx = (nx * (pad - 1)) // 2
    Pc = jnp.fft.fftshift(P, axes=(-2, -1))
    width = [(0, 0)] * (P.ndim - 2) + [(wy, wy), (wx, wx)]
    return jnp.fft.ifftshift(jnp.pad(Pc, width), axes=(-2, -1))


def n1_tt(qe: "QE", Ls, clkk, ells=None, pad: int = 2):
    """Flat-sky N1 lensing bias of the TT estimator, kappa convention.

    The O(C^phiphi) connected-trispectrum bias of Kesden, Cooray &
    Kamionkowski 2003 (eq. 12) — the debias term the reference
    ecosystem takes from quicklens/LensingBiases-style codes and that
    its tutorials stop short of (``tt_verification.ipynb`` subtracts
    N0 only; the 1-3 percent low-L excess it sees IS this term):

      N1(L) = 2 A(L)^2 int d^2l1/(2pi)^2 d^2l3/(2pi)^2
              F(l1,l2) F(l3,l4) C^pp(|l1+l3|) f(l1,l3) f(l2,l4)

    with l2 = L - l1, l4 = -L - l3, f the TT lensing response and F
    the estimator's own filtered weights (leg masks and total spectra
    taken straight from the engine). Evaluated EXACTLY on the
    estimator's Fourier lattice: f(l1,l3) and f(l2,l4) split into 6
    separable (u_a(l1) v_a(l3)) components each, the C^pp coupling is
    opened with its transform C~(x), and every l-integral collapses to
    a 2D FFT — 6 batched-(6) FFT pairs per L instead of a 4D
    quadrature. The x-space sum implements the lattice Kronecker
    delta, so ``pad=2`` doubles the Brillouin zone (same dl) to keep
    l1+l3 un-aliased; with it the result is bit-comparable to the
    direct 4D lattice sum (asserted to ~1e-10 by the brute-force
    parity test in tests/test_qe_n1.py).

    Isotropy note: L is taken along the x axis and the engine's leg
    masks / total spectra are radialized from their ly=0 row — exact
    for the annulus masks and 1D-interpolated spectra every reference
    workflow uses; anisotropic custom filters are outside this fast
    path.

    Parameters
    ----------
    Ls : 1D array of output multipoles (within the lattice band).
    clkk : 1D lensing-convergence input spectrum C_L^kk over ``ells``
        (default ``arange(len(clkk))``); converted internally to
        C^phiphi = 4 C^kk / L^4.
    pad : Brillouin-zone factor for the C^pp coupling (2 = exact).

    Returns
    -------
    (Ls, n1_kk) : numpy arrays; N1 in kappa convention
        (L^4/4) N1^phiphi.
    """
    geom = qe.geom
    dtype = qe.dtype
    clkk = np.asarray(clkk, np.float64)
    ells = (np.arange(clkk.size, dtype=np.float64) if ells is None
            else np.asarray(ells, np.float64))
    lsafe = np.where(ells > 0, ells, 1.0)
    clpp = np.where(ells > 0, 4.0 * clkk / lsafe ** 4, 0.0)

    # 1D profiles of the engine's own weights (see isotropy note)
    lt_c, cltt_t = _iso_profile(geom, qe.cl2d["TT"])
    ct_l, ct_v = _iso_profile(geom, qe.ctot["TT"])
    if qe.field_masks is not None:
        m1_l, m1_v = _iso_profile(geom, qe.field_masks["T"])
        m2_l, m2_v = m1_l, m1_v
    else:
        m1_l, m1_v = _iso_profile(geom, qe.gmask)
        m2_l, m2_v = _iso_profile(geom, qe.ymask)
    w1_t = np.where(ct_v > 0, m1_v / np.where(ct_v > 0, ct_v, 1.0), 0.0)
    w2_t = np.where(ct_v > 0, m2_v / np.where(ct_v > 0, ct_v, 1.0), 0.0)

    def _cl(m):
        return np.interp(m, lt_c, cltt_t, left=0.0, right=0.0)

    def _w1(m):
        return np.interp(m, m1_l, w1_t, left=0.0, right=0.0)

    def _w2(m):
        return np.interp(m, m2_l, w2_t, left=0.0, right=0.0)

    ny, nx = geom.shape
    ml_np = np.asarray(geom.modlmap_np())    # host f64 (never device f64)
    dly, dlx = float(ml_np[1, 0]), float(ml_np[0, 1])
    iy = np.fft.fftfreq(ny) * ny
    ix = np.fft.fftfreq(nx) * nx
    ly_np = (dly * iy)[:, None] + 0.0 * ix[None, :]
    lx_np = 0.0 * iy[:, None] + (dlx * ix)[None, :]
    # C^pp on the pad-times Brillouin zone (same dl): this is where
    # |l1+l3| lands, un-aliased for pad >= 2
    fy = np.fft.fftfreq(pad * ny) * pad * ny * dly
    fx = np.fft.fftfreq(pad * nx) * pad * nx * dlx
    ml_pad = np.hypot(fy[:, None], fx[None, :])
    cpp_pad = np.interp(ml_pad, ells, clpp, left=0.0, right=0.0)
    npdt = np.dtype(str(jnp.dtype(dtype)))

    npix_pad = pad * pad * geom.npix
    pref = 2.0 * (npix_pad / float(geom.area)) ** 2

    # L-independent l1/l3-side factors of the separable split
    # f(la, lb) = C(la)(|la|^2 + la.lb) + C(lb)(|lb|^2 + la.lb)
    # = sum_a u_a(la) v_a(lb) with the component pairing below
    C1 = _cl(ml_np)
    W1g = _w1(ml_np)
    one = np.ones_like(ml_np)
    U = np.stack([C1 * ml_np ** 2, C1 * lx_np, C1 * ly_np,
                  lx_np, ly_np, one])
    V = np.stack([one, lx_np, ly_np, C1 * lx_np, C1 * ly_np,
                  C1 * ml_np ** 2])

    Uc = jnp.asarray(U.astype(npdt))
    Vc = jnp.asarray(V.astype(npdt))
    cpp_d = jnp.asarray(cpp_pad.astype(npdt))

    @jax.jit
    def core(grids, Ug, Vg, cpp):
        """Device side: 6 batched-(6) FFT pairs + the C~(x)-weighted
        x-sum. All grid construction stays on the host (numpy) and
        arrives as real arguments; the complex C~(x) table is produced
        inside the jit from the real C^pp grid (one extra
        (pad*ny, pad*nx) FFT per call, negligible)."""
        F12, F34 = grids[0], grids[1]
        U2, V2 = grids[2:8], grids[8:14]
        cph = jnp.fft.ifft2(cpp)
        acc = jnp.zeros((), dtype)
        for a in range(6):
            Ia = jnp.fft.ifft2(_embed_pad(F12 * Ug[a] * U2, pad))
            Ja = jnp.fft.ifft2(_embed_pad(F34 * Vg[a] * V2, pad))
            acc = acc + (cph * (Ia * Ja).sum(0)).sum().real
        return pref * acc

    Ls = np.asarray(Ls, np.float64)
    aL = np.empty(Ls.size)
    n1_phi = np.empty(Ls.size)
    for i, Lx in enumerate(Ls):
        l2x = Lx - lx_np
        l4x = -Lx - lx_np
        ml2 = np.hypot(l2x, ly_np)
        ml4 = np.hypot(l4x, ly_np)
        C2, C4 = _cl(ml2), _cl(ml4)
        F12 = 0.5 * (C1 * (Lx * lx_np) + C2 * (Lx * l2x)) \
            * W1g * _w2(ml2)
        F34 = 0.5 * (C1 * (-Lx * lx_np) + C4 * (-Lx * l4x)) \
            * W1g * _w2(ml4)
        # A_L directly on the host from the same radialized tables
        # (== qe.A_L row for the isotropic filters this fast path
        # assumes, evaluated exactly at this L instead of a row
        # interp; avoids touching qe.A_L's device cache, whose cold
        # eager path is not portable to every backend)
        f12 = C1 * (Lx * lx_np) + C2 * (Lx * l2x)
        invA = (f12 * F12).sum() / float(geom.area)
        aL[i] = 1.0 / invA if invA != 0 else 0.0
        grids = np.stack(
            [F12, F34,
             C2 * ml2 ** 2, C2 * l2x, C2 * (-ly_np), l2x, -ly_np, one,
             one, l4x, -ly_np, C4 * l4x, C4 * (-ly_np), C4 * ml4 ** 2])
        n1_phi[i] = float(core(jnp.asarray(grids.astype(npdt)), Uc, Vc,
                               cpp_d))
    return Ls, (Ls ** 4 / 4.0) * aL ** 2 * n1_phi


def mcn0(qe: "QE", est: str, sim_kmaps, bin_edges, pair_shift: int = 1):
    """Monte-Carlo N0 from independent sim pairs alone (the
    ``- <Cl(Q[s,s'],...)>`` terms of :func:`rdn0` with a + sign):
    converges to the analytic ``QE.N_L_kk`` for matched spectra."""
    est = est.upper()
    sim_kmaps = jnp.asarray(sim_kmaps)
    nsims = sim_kmaps.shape[0]
    if nsims < 2:
        raise ValueError("mcn0 needs >= 2 sims")
    binner, cl = _kk_cl_fn(qe, bin_edges)
    shift = int(pair_shift) % nsims

    @jax.jit
    def run(sims):
        sims2 = jnp.roll(sims, -shift, axis=0)

        def one(pair):
            s, s2 = pair
            qss = qe.kappa_from_map(est, s, s2)
            qs2s = qe.kappa_from_map(est, s2, s)
            return cl(qss, qss) + cl(qss, qs2s)

        return jax.lax.map(one, (sims, sims2)).mean(axis=0)

    return binner.centers, np.asarray(run(sim_kmaps))
