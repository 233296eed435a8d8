"""Spherical-harmonic coefficient utilities without healpy.

The reference uses healpy for alm bookkeeping (``almxfl``, ``alm2cl``,
``Alm.getlmax``, ``change_alm_lmax`` at ``orphics/maps.py:2961``). These
are pure index arithmetic on the healpix alm packing
``idx = m (2 lmax + 1 - m) / 2 + l`` — reimplemented here as jittable
JAX ops (the per-index ell table is a static constant per lmax).
Full SHTs are out of flat-sky scope; alms here come from external data.
"""
from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["nalm", "getlmax", "lm_indices", "almxfl", "alm2cl",
           "change_alm_lmax", "synalm"]


def nalm(lmax: int) -> int:
    return (lmax + 1) * (lmax + 2) // 2


def getlmax(size: int) -> int:
    """Invert nalm (healpy ``Alm.getlmax``)."""
    lmax = int((np.sqrt(1 + 8 * size) - 3) // 2)
    if size <= 0 or nalm(lmax) != size:
        # size 0 would "validate" as lmax -1 (nalm(-1) == 0)
        raise ValueError(f"size {size} is not a valid alm length")
    return lmax


@lru_cache(maxsize=32)
def lm_indices(lmax: int):
    """(ells, ems) int32 numpy arrays for each healpix-packed alm index."""
    ls = np.concatenate([np.arange(m, lmax + 1) for m in range(lmax + 1)])
    ms = np.concatenate([np.full(lmax + 1 - m, m) for m in range(lmax + 1)])
    return ls.astype(np.int32), ms.astype(np.int32)


@jax.jit
def almxfl(alm, fl):
    """Multiply alm by a per-ell function (healpy ``almxfl``)."""
    alm = jnp.asarray(alm)
    lmax = getlmax(alm.shape[-1])
    ls, _ = lm_indices(lmax)
    fl = jnp.asarray(fl)
    fl = jnp.pad(fl, (0, max(0, lmax + 1 - fl.shape[0])))
    return alm * fl[jnp.asarray(ls)]


@jax.jit
def alm2cl(alm1, alm2=None):
    """Cross power spectrum of two alm arrays (healpy ``alm2cl``)."""
    alm1 = jnp.asarray(alm1)
    alm2 = alm1 if alm2 is None else jnp.asarray(alm2)
    lmax = getlmax(alm1.shape[-1])
    ls, ms = lm_indices(lmax)
    w = jnp.where(jnp.asarray(ms) == 0, 1.0, 2.0)
    prod = (alm1 * alm2.conj()).real * w
    # support stacked (..., nalm) alm (the healpy alm2cl array
    # contract): segment over the LAST axis
    lead = prod.shape[:-1]
    flat = prod.reshape((-1, prod.shape[-1]))
    ids = jnp.asarray(ls)
    sums = jax.vmap(lambda p: jax.ops.segment_sum(
        p, ids, num_segments=lmax + 1))(flat)
    sums = sums.reshape(lead + (lmax + 1,))
    return sums / (2.0 * jnp.arange(lmax + 1) + 1.0)


def change_alm_lmax(alm, lmax_new: int):
    """Truncate or zero-pad alms to a new lmax (reference
    ``orphics/maps.py:2961``)."""
    alm = np.asarray(alm)
    lmax_old = getlmax(alm.shape[-1])
    out = np.zeros(alm.shape[:-1] + (nalm(lmax_new),), dtype=alm.dtype)
    lmin = min(lmax_old, lmax_new)
    for m in range(lmin + 1):
        old0 = m * (2 * lmax_old + 1 - m) // 2 + m   # index of (l=m, m)
        new0 = m * (2 * lmax_new + 1 - m) // 2 + m
        n = lmin + 1 - m
        out[..., new0: new0 + n] = alm[..., old0: old0 + n]
    return out


@partial(jax.jit, static_argnames=("lmax", "dtype"))
def synalm(key, cl, lmax: int = None, dtype=jnp.complex64):
    """Gaussian alm realization of a spectrum (healpy ``synalm``).

    m=0 modes are real N(0, C_l); m>0 modes complex with total variance
    C_l (C_l/2 per component).
    """
    cl = jnp.asarray(cl)
    if lmax is None:
        lmax = cl.shape[0] - 1
    ls, ms = lm_indices(lmax)
    n = nalm(lmax)
    kr, ki = jax.random.split(key)
    re = jax.random.normal(kr, (n,))
    im = jax.random.normal(ki, (n,))
    clpad = jnp.pad(cl, (0, max(0, lmax + 1 - cl.shape[0])))
    sig = jnp.sqrt(jnp.maximum(clpad[jnp.asarray(ls)], 0.0))
    m0 = jnp.asarray(ms) == 0
    alm = jnp.where(m0, re * sig + 0j,
                    (re + 1j * im) * sig * (2.0 ** -0.5))
    return alm.astype(dtype)
