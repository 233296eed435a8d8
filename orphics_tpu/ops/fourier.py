"""2D Fourier calculus on flat-sky geometries.

JAX replacement for the FFT/power-spectrum machinery of the
reference's ``FourierCalc`` (``orphics/maps.py:1594-1679``) and the
``pixell.enmap`` fft conventions it relies on.

Normalization conventions (matching the reference numerically):

  * ``norm='raw'``   : plain ``jnp.fft.fft2`` / ``jnp.fft.ifft2``
                       (= ``enmap.fft(..., normalize=False)``).
  * ``norm='ortho'`` : unitary transforms, raw scaled by ``npix**-0.5``
                       for fft and ``npix**+0.5`` for ifft
                       (= ``enmap.fft(..., normalize=True)``).
  * ``norm='phys'``  : ortho additionally scaled by ``pixsize**±0.5`` so
                       amplitudes carry physical (steradian) units
                       (= ``enmap.fft(..., normalize='phys')``).

Power spectra: ``f2power(k1, k2) = Re(conj(k1) * k2) * area / npix**2``
with *raw* ffts, identical to reference ``orphics/maps.py:1605,1620-1624``.

Everything here broadcasts over arbitrary leading batch dimensions and is
jit/vmap friendly; the ffts map onto XLA's FFT (cuFFT on a GPU).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry

__all__ = [
    "fft2", "ifft2", "rfft2", "irfft2",
    "queb_rotmat", "iqu2teb", "teb2iqu",
    "f2power", "power2d", "mask_kspace", "filter_map", "kfilter",
    "gauss_beam", "gauss_beam_real", "interp1d_to_2d",
]


def _norm_factor(geom: Geometry, norm: str, inverse: bool):
    n = geom.npix
    if norm == "raw":
        return 1.0
    if norm == "ortho":
        return n ** 0.5 if inverse else n ** -0.5
    if norm == "phys":
        if inverse:
            return (n ** 0.5) / (geom.pixsize ** 0.5)
        return (n ** -0.5) * (geom.pixsize ** 0.5)
    raise ValueError(f"unknown norm {norm!r}")


def fft2(x, geom: Geometry, norm: str = "raw"):
    """Forward 2D FFT over the trailing two axes."""
    k = jnp.fft.fft2(x, axes=(-2, -1))
    fac = _norm_factor(geom, norm, inverse=False)
    return k if fac == 1.0 else k * fac


def ifft2(k, geom: Geometry, norm: str = "raw"):
    """Inverse 2D FFT over the trailing two axes.

    Note ``jnp.fft.ifft2`` already divides by npix; the 'raw' inverse here
    means the exact inverse of the 'raw' forward (i.e. numpy's default).
    """
    x = jnp.fft.ifft2(k, axes=(-2, -1))
    fac = _norm_factor(geom, norm, inverse=True)
    return x if fac == 1.0 else x * fac


def rfft2(x, geom: Geometry, norm: str = "raw"):
    k = jnp.fft.rfft2(x, axes=(-2, -1))
    fac = _norm_factor(geom, norm, inverse=False)
    return k if fac == 1.0 else k * fac


def irfft2(k, geom: Geometry, norm: str = "raw"):
    x = jnp.fft.irfft2(k, s=geom.shape, axes=(-2, -1))
    fac = _norm_factor(geom, norm, inverse=True)
    return x if fac == 1.0 else x * fac


# ------------------------------------------------------------------
# Spin-2 (Q,U) <-> (E,B) rotation
# ------------------------------------------------------------------

def queb_rotmat(geom: Geometry, inverse: bool = False, iau: bool = False,
                spin: int = 2, dtype=jnp.float32):
    """(2, 2, ny, nx) Fourier-plane rotation matrix between (Q,U) and (E,B).

    Healpix convention by default; IAU flips the angle sign. Same math as
    ``enmap.queb_rotmat`` used at reference ``orphics/maps.py:1607`` and
    ``orphics/pixcov.py:51``.
    """
    lmap = geom.lmap(dtype)
    sgn = -1.0 if iau else 1.0
    a = sgn * spin * jnp.arctan2(-lmap[1], lmap[0])
    c, s = jnp.cos(a), jnp.sin(a)
    if inverse:
        s = -s
    return jnp.stack([jnp.stack([c, -s]), jnp.stack([s, c])])


def iqu2teb(kmaps, geom: Geometry, iau: bool = False):
    """Rotate raw-FFT'd (I,Q,U) k-maps into (T,E,B).

    ``kmaps``: (..., 3, ny, nx) complex. Equivalent to the rotation inside
    reference ``FourierCalc.iqu2teb`` (``orphics/maps.py:1609-1617``).
    """
    rot = queb_rotmat(geom, iau=iau)
    # rotate the LAST TWO components (reference maps.py:1609 rotates
    # emap[..., -2:]): a (2, ny, nx) Q/U stack has no T slot
    t = kmaps[..., :-2, :, :]
    eb = jnp.einsum("abyx,...byx->...ayx", rot, kmaps[..., -2:, :, :])
    return jnp.concatenate([t, eb], axis=-3)


def teb2iqu(kmaps, geom: Geometry, iau: bool = False):
    """Inverse rotation: (T,E,B) k-maps -> (I,Q,U) k-maps."""
    rot = queb_rotmat(geom, inverse=True, iau=iau)
    t = kmaps[..., :-2, :, :]
    qu = jnp.einsum("abyx,...byx->...ayx", rot, kmaps[..., -2:, :, :])
    return jnp.concatenate([t, qu], axis=-3)


# ------------------------------------------------------------------
# Power spectra
# ------------------------------------------------------------------

def f2power(kmap1, kmap2, geom: Geometry, pixel_units: bool = False):
    """2D cross power of two *raw* FFT k-maps.

    ``Re(conj(k1) k2) * area / npix^2`` — reference ``orphics/maps.py:1620``.
    """
    norm = 1.0 if pixel_units else geom.area / geom.npix ** 2
    return (kmap1.conj() * kmap2).real * norm


def power2d(map1, map2=None, geom: Geometry = None, iau: bool = False,
            kmap1=None, kmap2=None, rot: bool = True):
    """2D (cross-)power of maps; with pol, full (ncomp, ncomp) matrix in TEB.

    Equivalent to reference ``FourierCalc.power2d`` (``orphics/maps.py:1639``).
    Returns ``(p2d, kmap1, kmap2)`` where k-maps are raw FFTs with the
    LAST TWO components rotated Q/U -> E/B for any ncomp > 1 (reference
    iqu2teb behavior); pass ``rot=False`` for multi-component stacks
    that are not polarization (the reference's ``rot`` flag).
    """
    def to_k(m):
        k = fft2(m, geom, "raw")
        if rot and m.ndim >= 3 and m.shape[-3] >= 2:
            k = iqu2teb(k, geom, iau=iau)
        return k

    if kmap1 is None:
        kmap1 = to_k(map1)
    if kmap2 is None:
        kmap2 = to_k(map2) if map2 is not None else kmap1
    if kmap1.ndim >= 3 and kmap1.shape[-3] > 1:
        p2d = f2power(kmap1[..., :, None, :, :], kmap2[..., None, :, :, :], geom)
    else:
        p2d = f2power(kmap1, kmap2, geom)
    return p2d, kmap1, kmap2


# ------------------------------------------------------------------
# k-space masks / filters / beams
# ------------------------------------------------------------------

def mask_kspace(geom: Geometry, lxcut=None, lycut=None, lmin=None, lmax=None,
                dtype=jnp.float32):
    """Binary Fourier-space mask (reference ``orphics/maps.py:1936``)."""
    ly, lx = geom.laxes(dtype)
    mask = jnp.ones(geom.shape, dtype=dtype)
    # reference boundary semantics (maps.py:1936): zero modlmap <= lmin
    # and >= lmax (STRICT keep); in particular lmin=0 removes DC
    if lmin is not None or lmax is not None:
        modlmap = geom.modlmap(dtype)
        if lmin is not None:
            mask = mask * (modlmap > lmin)
        if lmax is not None:
            mask = mask * (modlmap < lmax)
    if lxcut is not None:
        mask = mask * (jnp.abs(lx)[None, :] >= lxcut)
    if lycut is not None:
        mask = mask * (jnp.abs(ly)[:, None] >= lycut)
    return mask


@partial(jax.jit, static_argnames=("geom",))
def kfilter(x, kfilt, geom: Geometry):
    """Apply a 2D Fourier filter to a real map: ifft(filt * fft(x)).

    Reference ``filter_map`` (``orphics/maps.py:1922``).
    """
    k = fft2(x, geom, "raw")
    return ifft2(k * kfilt, geom, "raw").real


filter_map = kfilter


def gauss_beam(ell, fwhm_arcmin):
    """Gaussian beam transfer function b(l) (reference ``orphics/maps.py:1925``)."""
    from ..geometry import arcmin
    tht_fwhm = fwhm_arcmin * arcmin
    return jnp.exp(-(tht_fwhm ** 2.0) * (ell ** 2.0) / (16.0 * np.log(2.0)))


def gauss_beam_real(rs, fwhm_arcmin):
    """Real-space Gaussian beam profile, normalized to unit integral."""
    from ..geometry import arcmin
    sigma = fwhm_arcmin * arcmin / np.sqrt(8.0 * np.log(2.0))
    return jnp.exp(-0.5 * rs ** 2 / sigma ** 2) / (2 * np.pi * sigma ** 2)


def interp1d_to_2d(ells, cls, geom: Geometry = None, modlmap=None,
                   fill_value=0.0, dtype=jnp.float32):
    """Evaluate a 1D ell function on the 2D |l| grid by linear interpolation.

    The workhorse for painting theory/beam/noise curves onto the Fourier
    plane (role of ``enmap.spec2flat``-style interpolation and the many
    ``interp(ells,cls)(modlmap)`` calls in the reference).
    """
    if modlmap is None:
        modlmap = geom.modlmap(dtype)
    ells = jnp.asarray(ells, dtype=modlmap.dtype)
    cls = jnp.asarray(cls, dtype=modlmap.dtype)
    return jnp.interp(modlmap, ells, cls, left=fill_value, right=fill_value)
