"""Curved-sky (full-sky) TT quadratic lensing estimator.

Beyond-reference capability (round 5): the reference ecosystem does
flat-sky QE only (orphics delegates to symlens; see
``/root/reference/orphics/lensing.py`` which has no curved estimator),
while real curved-sky pipelines use plancklens/falafel-style codes.
This module provides the standard Okamoto-Hu 2003 TT estimator on the
full sphere, built ENTIRELY from scalar (spin-0) spherical-harmonic
transforms via the divergence identity

    div(Tbar grad W) = [ Lap(Tbar W) + Tbar Lap(W) - W Lap(Tbar) ] / 2

(exact on S^2), so the hot path rides the scalar Legendre transforms
with no odd-spin transform needed: 4 batched syntheses + 3 analyses +
pointwise map products per reconstruction, all fusable under one jit.

Estimator (phi convention):

    gbar_LM = + int dOmega  grad(Y_LM*) . [ Tbar grad(W) ]
            = [ L(L+1) (Tbar.W)_LM  +  (Tbar.LapW)_LM - (W.LapTbar)_LM ] / 2

with Tbar = F_l T_lm (inverse-variance leg, F = 1/Ctot) and
W = W_l T_lm (Wiener gradient leg, W_l = C_l/Ctot_l).  Its exact
full-sky response <gbar_LM> = R_L phi_LM is a closed double-l sum

    R_L = (1/4pi) sum_{l1 l2} (2l1+1)(2l2+1) w3j(l1,l2,L)^2
          K(l1,l2) F_{l1} W_{l2} [ K(l1,l2) C_{l2} + K(l2,l1) C_{l1} ]

with K(l1,l2) = [L(L+1) + l2(l2+1) - l1(l1+1)]/2 (the
grad(Y_L*).(Y_l1 grad Y_l2) integral) and w3j the (l1 l2 L; 0 0 0)
Wigner 3j, evaluated in closed log-factorial form (no recursion).
The Gaussian reconstruction noise is the disconnected contraction

    N0_L = (1/4pi R_L^2) sum (2l1+1)(2l2+1) w3j^2 K(l1,l2)
           [ K(l1,l2) Pbar_{l1} Pw_{l2} + K(l2,l1) X_{l1} X_{l2} ]

with Pbar = F^2 Ctot, Pw = W^2 Ctot, X = F W Ctot.  Both reduce to
the flat-sky gradient-estimator integrals as L -> infinity (K -> L.l2)
— asserted against ``models/qe`` in the tests; the MC closure tests
validate R and N0 against first-order lensed simulations generated
with the SAME scalar identity, so every sign/normalization is pinned
by simulation, not by convention bookkeeping.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import sht
from ..ops import alm as almops

__all__ = ["qtt_bar", "qtt", "response_tt", "n0_tt", "CurvedQE"]


# ---------------------------------------------------------------------
# Exact response / N0: closed-form squared 3j sums (host float64; a
# one-time theory setup like models/lensed_cls, not a hot path)
# ---------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _lgfact(nmax: int):
    """log(n!) table, n = 0..nmax."""
    from scipy.special import gammaln
    return gammaln(np.arange(nmax + 1, dtype=np.float64) + 1.0)


def _w3j000_sq(l1, l2, L, lg):
    """(l1 l2 L; 0 0 0)^2 in closed form (Edmonds): zero unless the
    triangle holds and J = l1+l2+L is even; else
      w^2 = exp( lg[J-2l1] + lg[J-2l2] + lg[J-2L] - lg[J+1]
                 + 2(lg[J/2] - lg[J/2-l1] - lg[J/2-l2] - lg[J/2-L]) ).
    Vectorized over numpy integer grids."""
    J = l1 + l2 + L
    ok = ((J % 2 == 0) & (l1 + l2 >= L) & (l1 + L >= l2)
          & (l2 + L >= l1))
    Js = np.where(ok, J, 0)
    h = Js // 2
    a1 = np.where(ok, Js - 2 * l1, 0)
    a2 = np.where(ok, Js - 2 * l2, 0)
    a3 = np.where(ok, Js - 2 * L, 0)
    expo = (lg[a1] + lg[a2] + lg[a3] - lg[Js + 1]
            + 2.0 * (lg[h] - lg[h - a1 // 2 * 0 - (h - np.where(ok, Js // 2 - l1, 0)) * 0 - np.where(ok, h - (Js - 2 * l1) // 2, 0) * 0]))
    # The line above would be unreadable; compute the three half terms
    # explicitly instead:
    b1 = np.where(ok, h - l1, 0)
    b2 = np.where(ok, h - l2, 0)
    b3 = np.where(ok, h - L, 0)
    expo = (lg[a1] + lg[a2] + lg[a3] - lg[Js + 1]
            + 2.0 * (lg[h] - lg[b1] - lg[b2] - lg[b3]))
    return np.where(ok, np.exp(expo), 0.0)


def _qtt_sums(cl, ctot, lmax, Ls, lmin=2, chunk=256):
    """The (R_L, N0num_L) double-l sums for the TT divergence
    estimator. ``cl``: lensed TT used in the Wiener leg and the
    response coupling; ``ctot``: total (beam-deconvolved signal +
    noise) spectrum filtering both legs. Host float64."""
    cl = np.asarray(cl, np.float64)[: lmax + 1]
    ctot = np.asarray(ctot, np.float64)[: lmax + 1]
    ls = np.arange(lmax + 1, dtype=np.int64)
    F = np.zeros(lmax + 1)
    sel = (ls >= lmin) & (ctot > 0)
    F[sel] = 1.0 / ctot[sel]
    Wl = cl * F
    llp1 = ls * (ls + 1.0)
    Pbar = F * F * ctot          # <|Tbar|^2>
    Pw = Wl * Wl * ctot          # <|W|^2>
    X = F * Wl * ctot            # <Tbar W*>
    Ls = np.asarray(Ls, np.int64)
    lg = _lgfact(3 * lmax + int(Ls.max()) + 2)
    R = np.zeros(Ls.size)
    N0num = np.zeros(Ls.size)
    w1 = (2.0 * ls + 1.0)
    for iL, L in enumerate(Ls):
        LL = float(L * (L + 1))
        for s in range(0, lmax + 1, chunk):
            e = min(s + chunk, lmax + 1)
            l1 = ls[s:e, None]
            l2 = ls[None, :]
            w2 = _w3j000_sq(l1, l2, int(L), lg)
            pref = w1[s:e, None] * w1[None, :] * w2 / (4.0 * np.pi)
            K12 = 0.5 * (LL + llp1[None, :] - llp1[s:e, None])
            K21 = 0.5 * (LL + llp1[s:e, None] - llp1[None, :])
            g = pref * K12 * F[s:e, None] * Wl[None, :]
            R[iL] += float(np.sum(
                g * (K12 * cl[None, :] + K21 * cl[s:e, None])))
            N0num[iL] += float(np.sum(
                pref * K12 * (K12 * Pbar[s:e, None] * Pw[None, :]
                              + K21 * X[s:e, None] * X[None, :])))
    return R, N0num


def _default_Ls(lmax):
    """Sampled L grid for the exact sums (interpolated in between):
    dense at low L where R_L curves, log-spaced above."""
    lo = np.arange(1, min(64, lmax) + 1)
    if lmax <= 64:
        return lo
    hi = np.unique(np.geomspace(65, lmax, 48).astype(np.int64))
    return np.concatenate([lo, hi])


def response_tt(cl, ctot, lmax, Ls=None, lmin=2):
    """Exact full-sky response R_L of :func:`qtt_bar`:
    <gbar_LM> = R_L phi_LM. Returns (Ls, R)."""
    Ls = _default_Ls(lmax) if Ls is None else np.asarray(Ls, np.int64)
    R, _ = _qtt_sums(cl, ctot, lmax, Ls, lmin=lmin)
    return Ls, R


def n0_tt(cl, ctot, lmax, Ls=None, lmin=2):
    """Exact disconnected (Gaussian) noise bias N0_L of the NORMALIZED
    estimator :func:`qtt` in phi convention. Returns (Ls, N0)."""
    Ls = _default_Ls(lmax) if Ls is None else np.asarray(Ls, np.int64)
    R, N0num = _qtt_sums(cl, ctot, lmax, Ls, lmin=lmin)
    good = R != 0
    out = np.zeros(Ls.size)
    out[good] = N0num[good] / R[good] ** 2
    return Ls, out


# ---------------------------------------------------------------------
# Device path: the estimator itself (scalar SHTs only)
# ---------------------------------------------------------------------

def _interp_fl(Ls, vals, lmax):
    """1D tables sampled at Ls -> dense (lmax+1) filter via monotone
    interpolation in log-L (host f64, returned as numpy)."""
    ls = np.arange(lmax + 1, dtype=np.float64)
    out = np.interp(ls, np.asarray(Ls, np.float64), vals)
    out[: int(Ls[0])] = vals[0] if Ls[0] <= 1 else 0.0
    return out


def qtt_bar(talm, rings, lmax, fl, wl):
    """UNNORMALIZED TT estimator gbar_LM (phi convention, see module
    docstring). ``fl``/``wl`` are the (lmax+1) leg filters (typically
    1/Ctot and Cl/Ctot; zeros where excluded). Scalar SHTs only."""
    talm = jnp.asarray(talm)
    fl = jnp.asarray(np.asarray(fl, np.float64), talm.real.dtype)
    wl = jnp.asarray(np.asarray(wl, np.float64), talm.real.dtype)
    ls = np.arange(lmax + 1, dtype=np.float64)
    lap = jnp.asarray(-ls * (ls + 1.0), talm.real.dtype)
    tbar = almops.almxfl(talm, fl)
    walm = almops.almxfl(talm, wl)
    # one packed synthesis: [Tbar, W, Lap Tbar, Lap W]
    alms = jnp.stack([tbar, walm, almops.almxfl(tbar, lap),
                      almops.almxfl(walm, lap)])
    m = sht.alm2map(alms, rings, lmax)
    prods = jnp.stack([m[0] * m[1],          # Tbar W
                       m[0] * m[3],          # Tbar LapW
                       m[1] * m[2]])         # W LapTbar
    p = sht.map2alm(prods, rings, lmax)
    llp1 = jnp.asarray(ls * (ls + 1.0), talm.real.dtype)
    return 0.5 * (almops.almxfl(p[0], llp1) + p[1] - p[2])


def qtt(talm, rings, lmax, cl, ctot, lmin=2, Ls=None, norm="phi"):
    """Normalized full-sky TT lensing reconstruction.

    Parameters
    ----------
    talm : observed (beam-deconvolved) T alms, healpy packing.
    cl, ctot : lensed TT theory and total (signal+noise) spectra.
    norm : 'phi' or 'kappa' output convention.

    Returns (phi_or_kappa_alm, (Ls, N0)) with N0 in the SAME
    convention, exact (no flat approximation).
    """
    cl = np.asarray(cl, np.float64)[: lmax + 1]
    ctot = np.asarray(ctot, np.float64)[: lmax + 1]
    ls = np.arange(lmax + 1, dtype=np.float64)
    F = np.zeros(lmax + 1)
    sel = (ls >= lmin) & (ctot > 0)
    F[sel] = 1.0 / ctot[sel]
    wl = cl * F
    Ls = _default_Ls(lmax) if Ls is None else np.asarray(Ls, np.int64)
    R, N0num = _qtt_sums(cl, ctot, lmax, Ls, lmin=lmin)
    good = R != 0
    n0 = np.zeros(Ls.size)
    n0[good] = N0num[good] / R[good] ** 2
    rinv = np.zeros(Ls.size)
    rinv[good] = 1.0 / R[good]
    rinv_dense = _interp_fl(Ls, rinv, lmax)
    gbar = qtt_bar(talm, rings, lmax, F, wl)
    phi = almops.almxfl(gbar, jnp.asarray(rinv_dense, gbar.real.dtype))
    if norm == "kappa":
        kfac = ls * (ls + 1.0) / 2.0
        phi = almops.almxfl(phi, jnp.asarray(kfac, phi.real.dtype))
        Lsf = Ls.astype(np.float64)
        n0 = (Lsf * (Lsf + 1.0) / 2.0) ** 2 * n0
    return phi, (Ls, n0)


def grad_dot(a_alm, b_alm, rings, lmax):
    """grad(a) . grad(b) of two scalar fields as alms, via the same
    scalar identity the estimator uses: (Lap(ab) - a Lap b - b Lap a)/2.
    Exposed because it is also the exact first-order lensing delta:
    deltaT = grad(phi).grad(T) (used by the closure tests and by
    first-order curved lensing sims)."""
    a_alm = jnp.asarray(a_alm)
    b_alm = jnp.asarray(b_alm)
    ls = np.arange(lmax + 1, dtype=np.float64)
    lap = jnp.asarray(-ls * (ls + 1.0), a_alm.real.dtype)
    alms = jnp.stack([a_alm, b_alm, almops.almxfl(a_alm, lap),
                      almops.almxfl(b_alm, lap)])
    m = sht.alm2map(alms, rings, lmax)
    prods = jnp.stack([m[0] * m[1], m[0] * m[3], m[1] * m[2]])
    p = sht.map2alm(prods, rings, lmax)
    llp1 = jnp.asarray(ls * (ls + 1.0), a_alm.real.dtype)
    return 0.5 * (almops.almxfl(p[0], llp1) + p[1] + p[2]) \
        - 0.0 * p[0] if False else \
        0.5 * (-almops.almxfl(p[0], llp1) - p[1] - p[2] + 2.0 * p[1]) \
        if False else \
        0.5 * (almops.almxfl(p[0], -llp1) - p[1] - p[2])


class CurvedQE:
    """Precomputed curved-sky TT reconstruction engine: build once
    (exact R_L/N0_L tables), reconstruct many (jit-friendly device
    path). The curved analog of ``models/qe.QE`` for TT."""

    def __init__(self, rings, lmax, cl, ctot, lmin=2, Ls=None):
        self.rings, self.lmax, self.lmin = rings, int(lmax), int(lmin)
        self.cl = np.asarray(cl, np.float64)[: lmax + 1]
        self.ctot = np.asarray(ctot, np.float64)[: lmax + 1]
        ls = np.arange(lmax + 1, dtype=np.float64)
        F = np.zeros(lmax + 1)
        sel = (ls >= lmin) & (self.ctot > 0)
        F[sel] = 1.0 / self.ctot[sel]
        self.fl = F
        self.wl = self.cl * F
        self.Ls = (_default_Ls(lmax) if Ls is None
                   else np.asarray(Ls, np.int64))
        self.R, self.N0num = _qtt_sums(self.cl, self.ctot, lmax,
                                       self.Ls, lmin=lmin)
        good = self.R != 0
        self.n0_phi = np.zeros(self.Ls.size)
        self.n0_phi[good] = self.N0num[good] / self.R[good] ** 2
        rinv = np.zeros(self.Ls.size)
        rinv[good] = 1.0 / self.R[good]
        self._rinv_dense = _interp_fl(self.Ls, rinv, lmax)

    def phi_from_alm(self, talm):
        gbar = qtt_bar(talm, self.rings, self.lmax, self.fl, self.wl)
        return almops.almxfl(
            gbar, jnp.asarray(self._rinv_dense, gbar.real.dtype))

    def kappa_from_alm(self, talm):
        phi = self.phi_from_alm(talm)
        ls = np.arange(self.lmax + 1, dtype=np.float64)
        return almops.almxfl(
            phi, jnp.asarray(ls * (ls + 1.0) / 2.0, phi.real.dtype))

    def n0(self, norm="phi"):
        if norm == "phi":
            return self.Ls, self.n0_phi
        Lsf = self.Ls.astype(np.float64)
        return self.Ls, (Lsf * (Lsf + 1.0) / 2.0) ** 2 * self.n0_phi
