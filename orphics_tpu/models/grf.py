"""Gaussian random field synthesis from theory spectra.

JAX replacement for reference ``MapGen`` (``orphics/maps.py:1553``),
which chains ``enmap.spec2flat`` (1D Cl -> 2D covsqrt), complex white noise
(``enmap.rand_gauss_harm``), a per-Fourier-pixel matrix multiply
(``enmap.map_mul``) and a unitary inverse FFT (``enmap.harm2map``).

Conventions (derived to reproduce the reference numerically):
  * 2D spectrum painted on the l-plane: ``C2d = interp(Cl)(modlmap)``.
  * covsqrt in "map_mul units": ``sqrt(C2d * npix / area)`` — this is
    ``enmap.spec2flat(shape, wcs, cov, 0.5)``'s scaling (see MapGen's 2D
    branch at ``orphics/maps.py:1570-1574`` which multiplies the 2D power
    by ``npix/area`` before ``multi_pow(·, 0.5)``).
  * white noise: eta = N(0,1) + i N(0,1) per Fourier pixel (variance 2);
    the final ``Re(unitary_ifft(covsqrt * eta))`` halves it back, giving a
    real GRF whose raw-FFT power ``|F|^2 * area/npix^2`` averages to C_l.

Everything takes explicit JAX PRNG keys and broadcasts over batch dims —
the reference's ``seed`` kwarg discipline (SURVEY §4) done right.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import Geometry
from ..ops import fourier as F

__all__ = ["eig_pow", "spec2flat", "cl2flat", "rand_kmap", "rand_map",
           "harm2map", "map2harm", "MapGen", "cmb_ps", "white_noise",
           "rand_hermitian_half", "rand_map_r", "covsqrt_half"]


def eig_pow(mat, exp, lim=1e-30):
    """Matrix power via eigendecomposition over the *leading* stack dims.

    ``mat``: (..., n, n) symmetric. Eigenvalues below ``lim`` relative to
    the max are zeroed (reference relies on ``enmap.multi_pow`` /
    ``utils.eigpow`` with the same guard).
    """
    mat = jnp.asarray(mat)
    w, v = jnp.linalg.eigh(mat)
    wmax = jnp.max(jnp.abs(w), axis=-1, keepdims=True)
    good = w > wmax * lim
    wexp = jnp.where(good, jnp.abs(w) ** exp * jnp.sign(w), 0.0)
    return jnp.einsum("...ab,...b,...cb->...ac", v, wexp, v)


def cl2flat(geom: Geometry, ells, cls, dtype=jnp.float32):
    """Paint a single 1D spectrum onto the 2D l-plane (no unit scaling)."""
    return F.interp1d_to_2d(ells, cls, geom, dtype=dtype)


def spec2flat(geom: Geometry, ps, exp: float = 1.0, dtype=jnp.float32):
    """1D (ncomp,ncomp,L) spectra -> 2D per-pixel matrix in map_mul units.

    Returns (ncomp, ncomp, ny, nx) equal to
    ``(interp(ps)(modlmap) * npix/area) ** exp`` taken as a matrix power —
    the role of ``enmap.spec2flat`` at reference ``orphics/maps.py:1573``.
    For 1D input ``ps`` of shape (L,), a (1,1,L) matrix is assumed.
    """
    ps = np.asarray(ps, dtype=np.float64)
    if ps.ndim == 1:
        ps = ps[None, None]
    ncomp, L = ps.shape[0], ps.shape[-1]
    # Matrix power on the 1D tables first (cheap, high precision, host ok),
    # then interpolate each entry onto the 2D plane.
    if exp != 1.0:
        stack = np.moveaxis(ps, -1, 0)  # (L, ncomp, ncomp)
        powd = np.asarray(eig_pow(jnp.asarray(stack), exp))
        ps_p = np.moveaxis(powd, 0, -1)
    else:
        ps_p = ps
    ells = np.arange(L, dtype=np.float64)
    modlmap = geom.modlmap(dtype)     # built once, shared by all entries
    flat = jnp.stack([
        jnp.stack([F.interp1d_to_2d(ells, ps_p[i, j], modlmap=modlmap,
                                    dtype=dtype)
                   for j in range(ncomp)])
        for i in range(ncomp)])
    scale = (geom.npix / geom.area) ** exp
    return flat * jnp.asarray(scale, dtype=dtype)


def rand_kmap(key, geom: Geometry, ncomp: int = None, dtype=jnp.float32):
    """Complex white noise on the Fourier plane (enmap.rand_gauss_harm):
    independent unit-variance real and imaginary parts per pixel."""
    shape = (geom.ny, geom.nx) if ncomp is None else (ncomp, geom.ny, geom.nx)
    kr, ki = jax.random.split(key)
    return (jax.random.normal(kr, shape, dtype=dtype)
            + 1j * jax.random.normal(ki, shape, dtype=dtype))


@partial(jax.jit, static_argnames=("geom", "iau"))
def harm2map(kmap, geom: Geometry, iau: bool = False):
    """Unitary inverse FFT of (T[,E,B]) k-maps to (I[,Q,U]) real maps.

    Equivalent to ``enmap.harm2map`` with ``normalize=True``: rotates the
    spin-2 (E,B) components to (Q,U) on the l-plane, then takes the real
    part of the unitary inverse FFT.
    """
    # rotate ONLY full (T,E,B) stacks: ncomp=2 synthesis is the
    # correlated-scalar-pair use case (e.g. Pow2Cat's kappa x delta),
    # not spin-2 polarization
    if kmap.ndim >= 3 and kmap.shape[-3] == 3:
        kmap = F.teb2iqu(kmap, geom, iau=iau)
    return F.ifft2(kmap, geom, "ortho").real


@partial(jax.jit, static_argnames=("geom", "iau"))
def map2harm(imap, geom: Geometry, iau: bool = False):
    """Unitary forward FFT of (I[,Q,U]) maps to (T[,E,B]) k-maps."""
    k = F.fft2(imap, geom, "ortho")
    if k.ndim >= 3 and k.shape[-3] == 3:
        k = F.iqu2teb(k, geom, iau=iau)
    return k


@partial(jax.jit, static_argnames=("geom", "iau", "harm", "dtype"))
def rand_map(key, geom: Geometry, covsqrt, iau: bool = False, harm: bool = False,
             dtype=jnp.float32):
    """Draw a GRF realization given a precomputed 2D covsqrt.

    ``covsqrt``: (ncomp, ncomp, ny, nx) from :func:`spec2flat` with
    ``exp=0.5``. Returns real maps (ncomp, ny, nx) — or the TEB k-maps if
    ``harm``. Batched via ``jax.vmap`` over keys.
    """
    ncomp = covsqrt.shape[0]
    eta = rand_kmap(key, geom, ncomp, dtype=dtype)
    kmap = jnp.einsum("abyx,byx->ayx", covsqrt.astype(dtype), eta)
    if harm:
        return kmap
    out = harm2map(kmap, geom, iau=iau)
    return out[0] if ncomp == 1 else out


def covsqrt_half(geom: Geometry, ells, cls, dtype=jnp.float32):
    """sqrt(C) * npix / sqrt(area) painted on the rfft half-plane — the
    synthesis filter for :func:`rand_map_r` (irfft route)."""
    modl = geom.modlmap_r(dtype)
    c2d = F.interp1d_to_2d(jnp.asarray(ells), jnp.asarray(cls), modlmap=modl)
    return jnp.sqrt(jnp.maximum(c2d, 0.0)) * (geom.npix / geom.area ** 0.5)


def rand_hermitian_half(key, geom: Geometry, dtype=jnp.float32):
    """Unit-variance complex noise on the rfft half-plane with the exact
    Hermitian symmetry of the rfft of a real white map.

    Non-self-conjugate modes: variance-1 circular complex. The two
    self-conjugate columns (lx=0 and, for even nx, lx=Nyquist) are made
    Hermitian along y via eta -> (a + conj(a[-y])) / sqrt(2), which leaves
    unit variance and makes the (0,0)/(ny/2,*) entries real.
    """
    ny, nxr = geom.ny, geom.nx // 2 + 1
    kr, ki = jax.random.split(key)
    a = (jax.random.normal(kr, (ny, nxr), dtype)
         + 1j * jax.random.normal(ki, (ny, nxr), dtype)) * np.float32(2 ** -0.5)
    sc_cols = [0] + ([nxr - 1] if geom.nx % 2 == 0 else [])
    cols = a[:, jnp.asarray(sc_cols)]
    mirrored = jnp.roll(cols[::-1, :], 1, axis=0)  # a[(-y) mod ny]
    herm = (cols + mirrored.conj()) * np.float32(2 ** -0.5)
    return a.at[:, jnp.asarray(sc_cols)].set(herm)


@partial(jax.jit, static_argnames=("geom", "dtype"))
def rand_map_r(key, geom: Geometry, covsqrt_h, dtype=jnp.float32):
    """Scalar GRF via the half-plane irfft route — statistically identical
    to :func:`rand_map` at ~half the FFT and RNG cost (the fast path).
    """
    eta = rand_hermitian_half(key, geom, dtype)
    return F.irfft2(covsqrt_h * eta, geom, "raw")


class MapGen:
    """Precompute covsqrt once, then draw maps fast (reference
    ``orphics/maps.py:1553`` ``MapGen``).

    >>> mgen = MapGen(geom, ps)          # ps: (ncomp,ncomp,L) or (L,)
    >>> imap = mgen.get_map(key)         # one realization
    >>> imaps = mgen.get_maps(keys)      # vmapped batch
    """

    def __init__(self, geom: Geometry, ps=None, covsqrt=None, dtype=jnp.float32):
        self.geom = geom
        self.dtype = dtype
        if covsqrt is not None:
            self.covsqrt = jnp.asarray(covsqrt, dtype=dtype)
        else:
            self.covsqrt = spec2flat(geom, ps, exp=0.5, dtype=dtype)
        self.ncomp = self.covsqrt.shape[0]

    def get_map(self, key, iau: bool = False, harm: bool = False):
        return rand_map(key, self.geom, self.covsqrt, iau=iau, harm=harm,
                        dtype=self.dtype)

    def get_maps(self, keys, iau: bool = False, harm: bool = False):
        return jax.vmap(lambda k: self.get_map(k, iau=iau, harm=harm))(keys)


def cmb_ps(theory, lmax: int = None, pols=("TT", "EE", "BB", "TE"),
           lensed: bool = True):
    """Assemble the (3,3,L) TEB power matrix from a TheorySpectra.

    Reference ``orphics/maps.py:1038`` ``cmb_ps``.
    """
    lmax = lmax or theory.lpad
    ells = np.arange(lmax + 1)
    get = theory.lCl if lensed else theory.uCl
    ps = np.zeros((3, 3, lmax + 1))
    ps[0, 0] = np.asarray(get("TT", ells))
    ps[1, 1] = np.asarray(get("EE", ells))
    ps[2, 2] = np.asarray(get("BB", ells))
    te = np.asarray(get("TE", ells))
    ps[0, 1] = te
    ps[1, 0] = te
    return ps


def white_noise(key, geom: Geometry, noise_muK_arcmin, ipsizemap=None,
                shape=None, dtype=jnp.float32):
    """White noise map with given sensitivity (reference
    ``orphics/maps.py:1246``). ``noise_muK_arcmin`` in muK-arcmin; variance
    per pixel = (noise * arcmin)^2 / pixsize."""
    from ..geometry import arcmin
    if ipsizemap is None:
        # per-pixel solid angle incl. the cos(dec) factor (reference
        # defaults to the psizemap, maps.py:1246); the flat scalar
        # understates noise by 1/sqrt(cos dec) off the equator
        ipsizemap = geom.pixsizemap(dtype)
    shape = shape if shape is not None else (geom.ny, geom.nx)
    sigma = (noise_muK_arcmin * arcmin) / jnp.sqrt(ipsizemap)
    return jax.random.normal(key, shape, dtype=dtype) * sigma
