"""Internal linear combination (ILC): Fourier-space, spectral, harmonic.

JAX re-design of the reference's ILC toolkit
(``orphics/maps.py:1952-2180`` and ``:371-470``): everything is batched
linear algebra per (Fourier pixel | ell), expressed as einsums that vmap
over the spectral axis and jit cleanly.

Conventions follow Delabrouille et al. / arXiv:1006.5599 as in the
reference: ``silc`` Eq 4, ``cilc`` Eq 18.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["silc", "cilc", "silc_weights", "cilc_weights",
           "silc_noise", "cilc_noise", "ilc_cov", "ilc_cinv",
           "ilc_empirical_cov", "calculate_harmonic_coadd_weights",
           "harmonic_coaddition", "kspace_coadd", "ilc_map_term",
           "ilc_comb_a_b", "linear_coadd_fused", "cilc_coadd_fused",
           "silc_coadd_fused", "kspace_coadd_fused",
           "apply_harmonic_coadd_weights", "ilc_def_response", "ilc_index"]


# The per-pixel band contractions are float32 products: keep them at full
# fp32 precision (a GPU would otherwise run them as TF32).
_PREC = jax.lax.Precision.HIGHEST


def _def_response(response, cinv):
    if response is None:
        return jnp.ones((cinv.shape[0],), cinv.dtype)
    return jnp.asarray(response, cinv.dtype)


def ilc_map_term(kmaps, cinv, response):
    """response^T . Cinv . kmaps (reference ``orphics/maps.py:2043``)."""
    kmaps = jnp.asarray(kmaps)
    return jnp.einsum("k,kl...,l...->...", response, cinv, kmaps,
                      precision=_PREC)


def ilc_comb_a_b(response_a, response_b, cinv):
    """a^T Cinv b per (pixel|ell) (reference ``orphics/maps.py:2047``)."""
    return jnp.einsum("k,kl...,l->...", jnp.asarray(response_a), cinv,
                      jnp.asarray(response_b), precision=_PREC)


def silc(kmaps, cinv, response=None):
    """Standard ILC of (nfreq, ...) k-maps with (nfreq, nfreq, ...) Cinv
    (reference ``orphics/maps.py:1952``)."""
    response = _def_response(response, cinv)
    return ilc_map_term(kmaps, cinv, response) * silc_noise(cinv, response)


def silc_noise(cinv, response=None):
    """ILC noise power 1 / (a^T Cinv a) (reference ``maps.py:2025``)."""
    response = _def_response(response, cinv)
    d = ilc_comb_a_b(response, response, cinv)
    return jnp.where(jnp.abs(d) > 0, 1.0 / jnp.where(d == 0, 1.0, d), 0.0)


def cilc(kmaps, cinv, response_a, response_b):
    """Constrained ILC deprojecting component b (reference ``maps.py:1975``)."""
    brb = ilc_comb_a_b(response_b, response_b, cinv)
    arb = ilc_comb_a_b(response_a, response_b, cinv)
    arM = ilc_map_term(kmaps, cinv, response_a)
    brM = ilc_map_term(kmaps, cinv, response_b)
    ara = ilc_comb_a_b(response_a, response_a, cinv)
    numer = brb * arM - arb * brM
    norm = ara * brb - arb ** 2
    return jnp.where(jnp.abs(norm) > 0, numer / jnp.where(norm == 0, 1.0, norm), 0.0)


def silc_weights(cinv, response=None):
    """Per-band standard-ILC weights w with ``silc(kmaps) = sum_b w_b
    kmap_b`` (the ILC is linear in the maps; precomputing w turns each
    coadd into one elementwise weighted sum)."""
    response = _def_response(response, cinv)
    cia = jnp.einsum("kl...,l->k...", cinv, response, precision=_PREC)
    return cia * silc_noise(cinv, response)[None]


def cilc_weights(cinv, response_a, response_b):
    """Per-band constrained-ILC weights w with ``cilc(kmaps) = sum_b w_b
    kmap_b`` (deprojects ``response_b``; same linearization as
    :func:`silc_weights`)."""
    response_a = jnp.asarray(response_a, cinv.dtype)
    response_b = jnp.asarray(response_b, cinv.dtype)
    cia = jnp.einsum("kl...,l->k...", cinv, response_a, precision=_PREC)
    cib = jnp.einsum("kl...,l->k...", cinv, response_b, precision=_PREC)
    brb = ilc_comb_a_b(response_b, response_b, cinv)
    arb = ilc_comb_a_b(response_a, response_b, cinv)
    ara = ilc_comb_a_b(response_a, response_a, cinv)
    numer = brb[None] * cia - arb[None] * cib
    norm = ara * brb - arb ** 2
    return jnp.where(jnp.abs(norm)[None] > 0,
                     numer / jnp.where(norm == 0, 1.0, norm)[None], 0.0)


def cilc_noise(cinv, response_a, response_b):
    """Constrained-ILC noise power (reference ``maps.py:2030``)."""
    brb = ilc_comb_a_b(response_b, response_b, cinv)
    ara = ilc_comb_a_b(response_a, response_a, cinv)
    arb = ilc_comb_a_b(response_a, response_b, cinv)
    numer = brb ** 2 * ara + arb ** 2 * brb - brb * arb * arb - arb * brb * arb
    denom = (ara * brb - arb ** 2) ** 2
    return jnp.where(jnp.abs(denom) > 0, numer / jnp.where(denom == 0, 1.0, denom), 0.0)


def ilc_cov(ells, cmb_ps, kbeams, freqs, noises, components=(), fdict=None,
            narray=None, analysis_beam=1.0, lmins=None, lmaxs=None,
            noise_only=False, inf=1e30):
    """Build the beam-deconvolved (nfreq, nfreq, ...) multi-frequency
    covariance (reference ``orphics/maps.py:2082``): CMB + instrument noise
    (beam-deconvolved) + foreground components from ``fdict[comp](ells,
    f1, f2)`` callables."""
    ells = np.asarray(ells)
    nfreq = len(freqs)
    base = np.zeros((nfreq, nfreq) + ells.shape)
    cov = base + (0.0 if noise_only else np.asarray(cmb_ps) * analysis_beam ** 2)
    if noise_only:
        components = ()
    for i in range(nfreq):
        for j in range(nfreq):
            if narray is not None:
                cov[i, j] += narray[i, j]
            elif i == j:
                with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                    instnoise = np.nan_to_num(
                        np.asarray(noises[i]) * analysis_beam ** 2
                        / np.asarray(kbeams[i]) ** 2)
                cov[i, j] = cov[i, j] + instnoise
            for comp in components:
                fg = np.nan_to_num(fdict[comp](ells, freqs[i], freqs[j]))
                fg[np.abs(fg) > 1e90] = 0
                cov[i, j] = cov[i, j] + fg * analysis_beam ** 2
            if i == j:
                if lmins is not None:
                    cov[i, j][ells < lmins[i]] = inf
                if lmaxs is not None:
                    cov[i, j][ells > lmaxs[i]] = inf
    return cov


def ilc_cinv(ells, cmb_ps, kbeams, freqs, noises, components=(), fdict=None,
             narray=None, eigpow=True, **kw):
    """Inverse multi-frequency covariance (reference ``maps.py:2146``)."""
    from .grf import eig_pow
    cov = np.nan_to_num(ilc_cov(ells, cmb_ps, kbeams, freqs, noises,
                                components, fdict=fdict, narray=narray, **kw))
    stack = jnp.moveaxis(jnp.asarray(cov), (0, 1), (-2, -1))
    if eigpow:
        cinv = eig_pow(stack, -1.0)
    else:
        cinv = jnp.linalg.inv(stack)
    return jnp.moveaxis(cinv, (-2, -1), (0, 1)), cov


def ilc_empirical_cov(kmaps, binner=None, modlmap=None):
    """Isotropic empirical covariance from k-maps: bin |ki kj*| radially
    and re-paint on the 2D plane (reference ``maps.py:2053``)."""
    ncomp = kmaps.shape[0]
    p = (kmaps[:, None] * kmaps[None, :].conj()).real
    if binner is None:
        return p
    cents, p1d = binner.bin(p)
    out = jax.vmap(lambda v: jnp.interp(modlmap.reshape(-1), jnp.asarray(cents),
                                        v).reshape(modlmap.shape))(
        p1d.reshape(-1, p1d.shape[-1]))
    return out.reshape(p.shape[:-2] + modlmap.shape)


def kspace_coadd(kmaps, kbeams, kncovs, fkbeam=1.0):
    """Noise-weighted coadd of non-deconvolved k-maps (reference
    ``orphics/maps.py:1098``): sum(k b f/N) / sum(b^2/N)."""
    kmaps = jnp.asarray(kmaps)
    kbeams = jnp.asarray(kbeams)
    kncovs = jnp.asarray(kncovs)
    numer = jnp.sum(kmaps * kbeams * fkbeam / kncovs, axis=0)
    numer = jnp.nan_to_num(numer, posinf=0.0, neginf=0.0)
    denom = jnp.sum(kbeams ** 2 / kncovs, axis=0)
    out = numer / denom
    return jnp.nan_to_num(out, posinf=0.0, neginf=0.0)


def calculate_harmonic_coadd_weights(lmax, cl_model, resp_factors, beams):
    """Per-ell ILC/coadd weights (reference ``orphics/maps.py:371``):
    w_l = Cinv_l a_l / (a_l^T Cinv_l a_l) with a_l = resp * B_l.

    ``cl_model``: dict[(i,j)] -> C_l of the observed (beam-convolved) sky.
    Returns (lmax+1, nfreq). Batched inverses ride ``jnp.linalg.inv``.
    """
    nfreq = len(beams)
    for b in beams:
        if np.asarray(b).size < lmax + 1:
            raise ValueError("beam transfer does not cover multipole range")
    cov = np.zeros((lmax + 1, nfreq, nfreq))
    for i in range(nfreq):
        for j in range(i, nfreq):
            spec = np.asarray(cl_model[(i, j)])[: lmax + 1]
            cov[:, i, j] = cov[:, j, i] = spec
    if not np.all(np.isfinite(cov)):
        raise ValueError("non-finite covariance model")
    resp = np.ones(nfreq) if resp_factors is None else np.asarray(resp_factors)
    beams_mat = np.vstack([np.asarray(b)[: lmax + 1] for b in beams])
    a_mat = (resp[:, None] * beams_mat).T                     # (lmax+1, nfreq)
    cinv = np.zeros_like(cov)
    cinv[2:] = np.asarray(jnp.linalg.inv(jnp.asarray(cov[2:])))
    num = np.einsum("lij,lj->li", cinv, a_mat)
    den = np.einsum("li,li->l", a_mat, num)
    w = np.zeros_like(num)
    w[2:] = num[2:] / den[2:, None]
    if not np.all(np.isfinite(w)):
        raise ValueError("non-finite weights")
    return w


def harmonic_coaddition(alms, beams, cl_model, target_beam, resp_factors=None,
                        return_weights=True):
    """Harmonic coaddition without explicit deconvolution (reference
    ``orphics/maps.py:442``): alm_out = sum_i almxfl(alm_i, w_li * B_target).
    """
    from ..ops.alm import almxfl, getlmax
    alms = [jnp.asarray(a) for a in alms]
    lmax = getlmax(alms[0].shape[-1])
    w = calculate_harmonic_coadd_weights(lmax, cl_model, resp_factors, beams)
    tb = np.asarray(target_beam)[: lmax + 1]
    out = 0.0
    for i, alm in enumerate(alms):
        out = out + almxfl(alm, jnp.asarray(w[:, i] * tb))
    if return_weights:
        return out, w
    return out


def ilc_def_response(response, cinv):
    """Default CMB response — vector of ones (reference
    ``maps.py:2006``)."""
    return _def_response(response, jnp.asarray(cinv))


def ilc_index(ndim):
    """Einsum spectral-index string for a cinv of this ndim (reference
    ``maps.py:2014``): 'p' for 1D-power matrices, 'pq' for 2D k-space
    matrices."""
    if ndim == 3:
        return "p"
    if ndim == 4:
        return "pq"
    raise ValueError(ndim)


def apply_harmonic_coadd_weights(alms, weights, target_beam):
    """Apply precomputed (lmax+1, nfreq) harmonic coadd weights to a
    list of alms and convolve with the target beam (reference
    ``maps.py:339``)."""
    from ..ops import alm as almops
    alms = [jnp.asarray(a) for a in alms]
    lmax = almops.getlmax(alms[0].shape[-1])
    w = jnp.asarray(weights)
    out = jnp.zeros_like(alms[0])
    for k, a in enumerate(alms):
        out = out + almops.almxfl(a, w[: lmax + 1, k])
    return almops.almxfl(out, jnp.asarray(target_beam)[: lmax + 1])


@jax.jit
def _linear_coadd(maps, w_half):
    k = jnp.fft.rfft2(maps)                          # (ncoadds, nfreq, ny, nxr)
    coadd = (k * w_half.astype(k.real.dtype)).sum(axis=1)
    return jnp.fft.irfft2(coadd, s=maps.shape[-2:])


def linear_coadd_fused(maps, w2d):
    """Coadd maps of per-band real maps under STATIC per-band 2D weight
    planes: out_j = ifft2(sum_b w_b o fft2(maps[j, b])), on the rfft half
    plane (one rfft2 per band map, one irfft2 per coadd).

    maps : (ncoadds, nfreq, ny, nx) real; w2d : (nfreq, ny, nx) real
    weights in natural FFT layout, required mirror-symmetric
    (w(-k) = w(k), true for any isotropic/1D-painted weights — the
    half-plane inverse assumes a Hermitian coadd spectrum). The generic
    primitive behind :func:`cilc_coadd_fused` / :func:`silc_coadd_fused`
    / :func:`kspace_coadd_fused`.
    """
    maps = jnp.asarray(maps, jnp.float32)
    nxr = maps.shape[-1] // 2 + 1
    w_half = jnp.asarray(np.asarray(w2d, np.float32)[..., :nxr])
    return _linear_coadd(maps, w_half)


def cilc_coadd_fused(maps, cinv, response_a, response_b, geom=None):
    """Constrained-ILC coadd MAPS — equal to
    ``ifft2(cilc(fft2(maps), cinv, a, b)).real`` (tested) for a
    mirror-symmetric (isotropic) ``cinv``; see
    :func:`linear_coadd_fused` for the mechanics and requirements."""
    w2d = np.asarray(cilc_weights(jnp.asarray(cinv), response_a,
                                  response_b), np.float32)
    return linear_coadd_fused(maps, w2d)


def silc_coadd_fused(maps, cinv, response=None):
    """Standard-ILC coadd MAPS (the ``silc`` counterpart of
    :func:`cilc_coadd_fused`)."""
    w2d = np.asarray(silc_weights(jnp.asarray(cinv), response),
                     np.float32)
    return linear_coadd_fused(maps, w2d)


def kspace_coadd_fused(maps, kbeams2d, kncovs2d, fkbeam=1.0):
    """Noise-weighted k-space coadd of non-deconvolved maps (reference
    ``kspace_coadd`` semantics, ``maps.py:1098``: sum(k b f / N) /
    sum(b^2 / N) — a static per-band linear filter)."""
    kbeams2d = np.asarray(kbeams2d, np.float64)
    kncovs2d = np.asarray(kncovs2d, np.float64)
    # zero-noise pixels produce inf/inf = NaN weights that one FFT
    # spreads to every output pixel — sanitize like the unfused
    # kspace_coadd does
    with np.errstate(divide="ignore", invalid="ignore"):
        ib2 = np.nan_to_num(kbeams2d ** 2 / kncovs2d,
                            posinf=0.0, neginf=0.0)
        denom = ib2.sum(axis=0)
        w2d = np.nan_to_num(
            kbeams2d * np.asarray(fkbeam) / kncovs2d
            / np.where(denom == 0, 1.0, denom),
            posinf=0.0, neginf=0.0)
    return linear_coadd_fused(maps, w2d.astype(np.float32))
