"""Linear-model fitting, PTEs, sampling, and covariance utilities.

Reference: ``orphics/stats.py`` — ``fit_linear_model`` (:168),
``fit_linear_model_pte_from_sims`` (:192), ``fit_gauss`` (:203),
``sim_pte/get_pte/nsigma_from_pte`` (:47,43,39),
``InverseTransformSampling`` (:55), ``Solver``/``solve`` (:213,232),
``OQE`` (:365), ``CinvUpdater``/``sm_update`` (:494,525), ``eig_pow``
(:517), ``cov2corr`` (:542), ``correlated_hybrid_matrix`` (:549),
``extrapolate_power_law`` (:18), ``get_sigma2`` (:133), ``npspace``
(:775). Implemented with jnp linear algebra (batched-friendly) and host
scipy only for the nonlinear curve fits.
"""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["fit_linear_model", "fit_linear_model_pte_from_sims", "fit_gauss",
           "get_pte", "sim_pte", "nsigma_from_pte", "pte_from_nsigma",
           "InverseTransformSampling", "InverseTransformSampling2D",
           "eig_analyze", "Solver", "solve", "OQE",
           "CinvUpdater", "sm_update", "cov2corr",
           "correlated_hybrid_matrix", "extrapolate_power_law",
           "get_sigma2", "npspace", "alpha_from_confidence", "timeit"]


def npspace(minim, maxim, num, scale="lin"):
    if scale in ("lin", "linear"):
        return np.linspace(minim, maxim, num)
    if scale == "log":
        return np.logspace(np.log10(minim), np.log10(maxim), num)
    raise ValueError(scale)


# ------------------------------------------------------------------
# PTEs
# ------------------------------------------------------------------

def nsigma_from_pte(pte):
    from scipy.special import erfinv
    return erfinv(1 - pte) * np.sqrt(2)


def pte_from_nsigma(nsigma):
    from scipy.special import erf
    return 1 - erf(nsigma / np.sqrt(2))


def get_pte(chisquare_data, chisquares_sims):
    sims = np.asarray(chisquares_sims)
    return sims[chisquare_data < sims].size / sims.size


def sim_pte(data, covmat, nsamples, key=None):
    """PTE of data chi^2 against Gaussian draws from covmat
    (reference ``stats.py:55``)."""
    data = jnp.asarray(data)
    covmat = jnp.asarray(covmat)
    cinv = jnp.linalg.inv(covmat)
    chisq = float(data @ cinv @ data)
    if key is None:
        key = jax.random.PRNGKey(0)
    L = jnp.linalg.cholesky(covmat)
    draws = jax.random.normal(key, (nsamples, data.shape[0]), covmat.dtype)
    samples = draws @ L.T
    chis = jnp.einsum("ij,jk,ik->i", samples, cinv, samples)
    return get_pte(chisq, np.asarray(chis))


# ------------------------------------------------------------------
# Linear-model fits
# ------------------------------------------------------------------

def fit_linear_model(x, y, ycov, funcs, dofs=None, deproject=False,
                     Cinv=None, Cy=None):
    """GLS fit of y = sum_i a_i f_i(x); returns (coeffs, coeff_cov,
    chi2/dof, pte) — reference ``stats.py:168``."""
    from scipy.stats import chi2 as chi2dist
    x = np.asarray(x)
    y = np.asarray(y).reshape(-1, 1)
    C = np.asarray(ycov)
    A = np.stack([np.asarray(f(x)) for f in funcs], axis=1)
    s = (lambda M, v: solve(M, v)) if deproject else np.linalg.solve
    CA = s(C, A) if Cinv is None else Cinv @ A
    cov = np.linalg.inv(A.T @ CA)
    if Cy is None:
        Cy = s(C, y) if Cinv is None else Cinv @ y
    X = cov @ (A.T @ Cy)
    YAX = y - A @ X
    CYAX = s(C, YAX) if Cinv is None else Cinv @ YAX
    chisq = float((YAX.T @ CYAX).ravel()[0])
    dofs = len(x) - len(funcs) if dofs is None else dofs
    pte = 1 - chi2dist.cdf(chisq, dofs)
    return X, cov, chisq / dofs, pte


def fit_linear_model_pte_from_sims(x, y, ycov, funcs, y_fiducial,
                                   nsims=10000, key=None, **kw):
    """PTE of the fit chi^2 against fiducial-model Gaussian sims
    (reference ``stats.py:192``), with the per-sim GLS solved as one
    batched jnp program instead of a Python loop."""
    X_data, cov_data, chisq_data, _ = fit_linear_model(x, y, ycov, funcs)
    x = np.asarray(x)
    C = jnp.asarray(ycov)
    A = jnp.asarray(np.stack([np.asarray(f(x)) for f in funcs], axis=1))
    L = jnp.linalg.cholesky(C)
    if key is None:
        key = jax.random.PRNGKey(1)
    draws = jax.random.normal(key, (nsims, len(x)), C.dtype) @ L.T
    samples = jnp.asarray(y_fiducial) + draws
    Cinv = jnp.linalg.inv(C)
    cov = jnp.linalg.inv(A.T @ Cinv @ A)

    def chisq_one(yv):
        X = cov @ (A.T @ (Cinv @ yv))
        r = yv - A @ X
        return r @ Cinv @ r

    chis = np.asarray(jax.vmap(chisq_one)(samples)) / (len(x) - len(funcs))
    pte = get_pte(chisq_data, chis)
    return X_data, cov_data, chisq_data, pte


def fit_cltt_power(ells, cls, cltt_func, w0, sigma2, ell0=0, alpha=1,
                   fix_knee=False):
    """Fit binned TT power to theory + white + red noise amplitudes
    (reference ``stats.py:148``). Returns a callable model."""
    from scipy.optimize import curve_fit
    from ..geometry import arcmin
    ells = np.asarray(ells, dtype=float)
    cls = np.asarray(cls, dtype=float)
    sw0 = w0 * arcmin
    if fix_knee:
        funcs = [lambda x: np.full_like(np.asarray(x, float), sw0 ** 2)]
        p0 = [1.0]
    else:
        funcs = [lambda x: np.full_like(np.asarray(x, float), sw0 ** 2),
                 lambda x: (sw0 ** 2 * (ell0 / np.asarray(x, float))
                            ** (-alpha) if ell0 > 1e-3
                            else np.full_like(np.asarray(x, float), sw0 ** 2))]
        p0 = [1.0, ell0 if ell0 > 1e-3 else 1.0]
    model = lambda x, *args: sum(a * f(x) for a, f in zip(args, funcs))
    X, _ = curve_fit(model, ells, cls - np.asarray(cltt_func(ells)),
                     p0=p0, sigma=np.sqrt(np.asarray(sigma2)),
                     absolute_sigma=True, bounds=(0, np.inf))
    return lambda x: (np.asarray(cltt_func(x))
                      + sum(c * f(x) for c, f in zip(X, funcs)))


def fit_gauss(x, y, mu_guess=None, sigma_guess=None):
    """Gaussian fit to a curve (reference ``stats.py:203``)."""
    from scipy.optimize import curve_fit
    x = np.asarray(x)
    y = np.asarray(y)
    ynorm = np.trapezoid(y, x)
    yn = y / ynorm
    gaussian = lambda t, mu, s: np.exp(-(t - mu) ** 2 / 2 / s ** 2) \
        / np.sqrt(2 * np.pi * s ** 2)
    popt, _ = curve_fit(gaussian, x, yn, p0=[mu_guess, sigma_guess])
    return popt[0], abs(popt[1]), ynorm, yn


def get_sigma2(ells, cls, w0, delta_ells, fsky, ell0=0, alpha=1,
               w0p=None, ell0p=0, alphap=1, clxx=None, clyy=None):
    """Knox per-bandpower variance of an auto or cross spectrum with
    atmospheric (red) noise — same signature and semantics as reference
    ``stats.py:133``: the noise term is the red component alone
    ``(w0 rad)^2 (ell0/l)^{-alpha}`` (zero when ``ell0`` is), and the
    result is divided by the bandpower width ``delta_ells``."""
    from ..geometry import arcmin
    ells = np.asarray(ells, dtype=float)
    afact = ((ell0 / ells) ** (-alpha)) if ell0 > 1e-3 else 0.0 * ells
    nlxx = (w0 * arcmin) ** 2 * afact
    if clxx is not None:
        afact = ((ell0p / ells) ** (-alphap)) if ell0 > 1e-3 else 0.0 * ells
        nlyy = (w0p * arcmin) ** 2 * afact
        tcl2 = np.asarray(cls) ** 2 + (clxx + nlxx) * (clyy + nlyy)
    else:
        assert clyy is None and w0p is None
        tcl2 = 2.0 * (np.asarray(cls) + nlxx) ** 2
    return tcl2 / (2 * ells + 1) / fsky / delta_ells


# ------------------------------------------------------------------
# Cinv application with deprojection
# ------------------------------------------------------------------

class Solver:
    """Apply C^-1 with rank-k template deprojection (reference
    ``stats.py:213``)."""

    def __init__(self, C, u=None):
        C = jnp.asarray(C)
        N = C.shape[0]
        if u is None:
            u = jnp.ones((N, 1), C.dtype)
        u = jnp.asarray(u)
        Cinvu = jnp.linalg.solve(C, u)
        self.precalc = Cinvu @ jnp.linalg.solve(u.T @ Cinvu, u.T)
        self.C = C

    def solve(self, x):
        Cinvx = jnp.linalg.solve(self.C, jnp.asarray(x))
        return Cinvx - self.precalc @ Cinvx


def solve(C, x, u=None):
    """Deprojected C^-1 x (reference ``stats.py:232``)."""
    return np.asarray(Solver(C, u=u).solve(x))


# ------------------------------------------------------------------
# Optimal quadratic estimator (reference stats.py:365)
# ------------------------------------------------------------------

class OQE:
    """Optimal quadratic estimator for Gaussian likelihoods: precomputes
    C^-1 dC/dp products and the Fisher matrix; ``estimate(data)`` returns
    bias-subtracted parameter estimates."""

    def __init__(self, fid_cov, dcov_dict: Dict, fid_params_dict: Dict,
                 deproject=True, templates=None):
        self.params = list(dcov_dict.keys())
        self.fids = fid_params_dict
        fid_cov = jnp.asarray(fid_cov)
        if deproject:
            self._solver = Solver(fid_cov, u=templates)
            slv = self._solver.solve
        else:
            slv = lambda x: jnp.linalg.solve(fid_cov, jnp.asarray(x))
        self.solver = slv
        self.ps = {p: np.asarray(slv(jnp.asarray(dcov_dict[p])))
                   for p in self.params}
        self.biases = {p: np.trace(self.ps[p]) for p in self.params}
        n = len(self.params)
        self.Fisher = np.zeros((n, n))
        for (p1, p2) in itertools.combinations_with_replacement(self.params, 2):
            i, j = self.params.index(p1), self.params.index(p2)
            self.Fisher[i, j] = 0.5 * np.trace(self.ps[p1] @ self.ps[p2])
            self.Fisher[j, i] = self.Fisher[i, j]
        self.Finv = np.linalg.inv(self.Fisher)
        self.marg_errors = np.sqrt(np.diagonal(self.Finv))

    def sigma(self):
        return dict(zip(self.params, self.marg_errors.tolist()))

    def estimate(self, data):
        data = np.asarray(data)
        cinvdat = np.asarray(self.solver(jnp.asarray(data)))
        vec = [float(data.T @ self.ps[p] @ cinvdat) - self.biases[p]
               for p in self.params]
        ans = 0.5 * self.Finv @ np.asarray(vec)
        return {p: self.fids[p] + ans[i] for i, p in enumerate(self.params)}


OQESlim = OQE  # the deproject=True specialization is the default here


# ------------------------------------------------------------------
# Rank-1 covariance updates (reference stats.py:494-540)
# ------------------------------------------------------------------

def sm_update(Ainv, u, v=None):
    """Sherman-Morrison: (A + u v^T)^-1 from A^-1."""
    Ainv = jnp.asarray(Ainv)
    u = jnp.asarray(u).reshape(-1, 1)
    v = u if v is None else jnp.asarray(v).reshape(-1, 1)
    ldot = float(jnp.squeeze(v.T @ (Ainv @ u)))
    det_update = 1.0 + ldot
    ans = Ainv - (Ainv @ (u @ v.T) @ Ainv) / det_update
    return ans, det_update


class CinvUpdater:
    """Amplitude-scaled rank-1 updates of a set of Cinvs (reference
    ``stats.py:494``) — for profile-amplitude likelihoods."""

    def __init__(self, cinvs, logdets, profile):
        self.cinvs = [jnp.asarray(c) for c in cinvs]
        self.logdets = logdets
        u = jnp.asarray(profile).reshape(-1, 1)
        self.update_unnormalized = [c @ (u @ u.T) @ c for c in self.cinvs]
        self.det_unnormalized = [float(jnp.squeeze(u.T @ (c @ u)))
                                 for c in self.cinvs]

    def get_cinv(self, index, amplitude):
        det_update = 1.0 + amplitude ** 2 * self.det_unnormalized[index]
        cinv = (self.cinvs[index]
                - amplitude ** 2 * self.update_unnormalized[index] / det_update)
        return cinv, np.log(det_update) + self.logdets[index]


# ------------------------------------------------------------------
# misc covariance utilities
# ------------------------------------------------------------------

def cov2corr(mat):
    mat = np.asarray(mat)
    d = np.sqrt(np.diagonal(mat))
    return mat / d[:, None] / d[None, :]


def correlated_hybrid_matrix(data_covmat, theory_covmat=None,
                             theory_corr=None, cap=True, cap_off=0.99):
    """Diagonal data variances + theory correlation structure
    (reference ``stats.py:549``)."""
    if theory_corr is None:
        theory_corr = cov2corr(theory_covmat)
    r = np.array(theory_corr, copy=True)
    if cap:
        r = np.clip(r, -cap_off, cap_off)
        np.fill_diagonal(r, 1.0)
    d = np.sqrt(np.diagonal(np.asarray(data_covmat)))
    return r * d[:, None] * d[None, :]


def extrapolate_power_law(x, y, x_extra, x_percentile=30.0):
    """Power-law extension of a curve from its high-x tail
    (reference ``stats.py:18``)."""
    from scipy.optimize import curve_fit
    x = np.asarray(x)
    y = np.asarray(y)
    threshold = np.percentile(x, 100 - x_percentile)
    sel = x >= threshold
    popt, _ = curve_fit(lambda xx, a, b: a * xx ** b, x[sel], y[sel])
    y_extra = popt[0] * np.asarray(x_extra) ** popt[1]
    return np.append(x, x_extra), np.append(y, y_extra)


class InverseTransformSampling:
    """Sample from an arbitrary tabulated 1D PDF (reference
    ``stats.py:55``), with JAX keys."""

    def __init__(self, xvals, pdf_vals):
        x = np.asarray(xvals, dtype=np.float64)
        p = np.maximum(np.asarray(pdf_vals, dtype=np.float64), 0)
        cdf = np.concatenate([[0.0], np.cumsum(0.5 * (p[1:] + p[:-1])
                                               * np.diff(x))])
        cdf /= cdf[-1]
        self._x = jnp.asarray(x)
        self._cdf = jnp.asarray(cdf)

    def generate(self, nsamples, key=None):
        if key is None:
            key = jax.random.PRNGKey(0)
        u = jax.random.uniform(key, (nsamples,))
        return jnp.interp(u, self._cdf, self._x)


def alpha_from_confidence(c):
    """n-sigma for c-probability enclosure of a 2D Gaussian
    (reference ``stats.py:~250``)."""
    return np.sqrt(2.0 * np.log(1.0 / (1.0 - c)))


def timeit(fn):
    """Wall-time decorator (reference ``stats.py:902``); blocks on device
    results so the number is honest on an accelerator."""
    import functools
    import time as _time

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        t0 = _time.perf_counter()
        out = fn(*a, **kw)
        jax.block_until_ready(out)
        print(f"{fn.__name__}: {_time.perf_counter() - t0:.6f} s")
        return out

    return wrapped


class InverseTransformSampling2D:
    """Sample from an arbitrary tabulated 2D PDF p(y, x) (reference
    ``stats.py:120``), fully vectorized: the marginal p(y) and every
    conditional p(x|y) CDF are tabulated once as dense grids, and
    ``generate`` is interp lookups (no per-sample Python loops — the
    reference builds a Python list of per-row samplers and loops)."""

    def __init__(self, ys, xs, updf, bounds_error=False):
        ys = np.asarray(ys, np.float64)
        xs = np.asarray(xs, np.float64)
        pdf = np.maximum(np.asarray(updf, np.float64), 0.0)
        pdf = pdf / np.trapezoid(np.trapezoid(pdf, xs), ys)
        self.ys = jnp.asarray(ys)
        self.xs = jnp.asarray(xs)
        mpdf_y = np.trapezoid(pdf, xs)                    # (ny,)
        cdf_y = np.concatenate([[0.0], np.cumsum(
            0.5 * (mpdf_y[1:] + mpdf_y[:-1]) * np.diff(ys))])
        self._cdf_y = jnp.asarray(cdf_y / cdf_y[-1])
        with np.errstate(invalid="ignore", divide="ignore"):
            cpdf = np.nan_to_num(pdf / mpdf_y[:, None])   # p(x | y)
        ccdf = np.concatenate(
            [np.zeros((len(ys), 1)),
             np.cumsum(0.5 * (cpdf[:, 1:] + cpdf[:, :-1])
                       * np.diff(xs)[None, :], axis=1)], axis=1)
        ccdf = ccdf / np.maximum(ccdf[:, -1:], 1e-300)
        self._ccdf = jnp.asarray(ccdf)                    # (ny, nx)

    def generate(self, nsamples, key=None):
        """Returns (ysamples, xsamples) arrays of length nsamples."""
        if key is None:
            key = jax.random.PRNGKey(0)
        ky, kx = jax.random.split(key)
        uy = jax.random.uniform(ky, (nsamples,))
        ysamp = jnp.interp(uy, self._cdf_y, self.ys)
        iy = jnp.clip(jnp.searchsorted(self.ys, ysamp), 0,
                      self.ys.shape[0] - 1)
        ux = jax.random.uniform(kx, (nsamples,))
        xsamp = jax.vmap(lambda u, i: jnp.interp(u, self._ccdf[i],
                                                 self.xs))(ux, iy)
        return ysamp, xsamp


def eig_analyze(cmb2d, start=0, eigfunc=np.linalg.eigh, plot_file=None):
    """Eigenvalue diagnostic of a (ncomp, ncomp, ny, nx) 2D power matrix
    (reference ``stats.py:~190``): prints the minimum eigenvalue and
    whether any are negative; optionally plots the sorted spectra."""
    es = eigfunc(np.asarray(cmb2d)[start:, start:, ...].T)[0]
    print(start, es.min(), np.any(es < 0.0))
    if plot_file is not None:
        from .io import Plotter
        numw = range(int(np.prod(es.shape[:-1])))
        pl = Plotter(xlabel="n", ylabel="e", yscale="log")
        for ind in range(es.shape[-1]):
            pl.add(numw, np.sort(np.real(es[..., ind].ravel())))
            pl.add(numw, np.sort(np.imag(es[..., ind].ravel())), ls="--")
        pl.done(plot_file)
    return es
