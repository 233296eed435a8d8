"""Binned power spectra of flat-sky maps and Gaussian sims, batched.

The reference measures bandpowers with ``maps.FourierCalc.power2d`` +
``stats.bin2D`` (``orphics/maps.py:1594-1650``, ``orphics/stats.py:782``)
— FFT, square, digitize/bincount per map. :class:`FastCl` packages that
pipeline behind one object on the rfft half-plane:

  * real-to-complex FFTs (``jnp.fft.rfft2``/``irfft2``), which carry the
    Hermitian half of every spectrum and nothing else;
  * GRF synthesis as white noise drawn with ``jax.random`` on the half
    plane, scaled by the theory covsqrt, then ``irfft2`` to real maps;
  * :class:`~orphics_tpu.ops.binning.RfftBin2D`, whose multiplicity
    weights reproduce full-plane binning exactly.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import Geometry
from ..ops.binning import RfftBin2D
from . import grf as _grf

__all__ = ["FastCl"]


class FastCl:
    """GRF-simulation / bandpower engine on a fixed geometry.

    Parameters
    ----------
    geom : Geometry of the maps (any shape).
    ells, cl1d : 1D theory spectrum for simulation. Optional — pass None
        to use :meth:`map_bandpowers` / :meth:`cross_bandpowers` only.
    bin_edges : radial bin edges (digitize right=True semantics, as the
        reference's ``bin2D``).
    strategy : binning strategy (see :mod:`orphics_tpu.ops.binning`);
        None picks the platform default.
    """

    def __init__(self, geom: Geometry, ells=None, cl1d=None,
                 bin_edges=None, strategy: str = None):
        if bin_edges is None:
            raise ValueError("FastCl requires bin_edges")
        self.geom = geom
        self.binner = RfftBin2D(geom, np.asarray(bin_edges),
                                strategy=strategy)
        self.centers = self.binner.centers
        self._norm = float(geom.area) / float(geom.npix) ** 2
        self._covsqrt_h = None
        if cl1d is not None:
            cl = np.asarray(cl1d, np.float64)
            if ells is None:
                ells = np.arange(len(cl))
            ells = np.asarray(ells, np.float64)
            if len(ells) != len(cl):
                raise ValueError("ells and cl1d length mismatch")
            self._covsqrt_h = _grf.covsqrt_half(geom, ells, cl,
                                                dtype=jnp.float32)

    def _binned_power(self, k1, k2):
        p = (k1 * k2.conj()).real * jnp.float32(self._norm)
        return self.binner.bin(p)[1]

    @partial(jax.jit, static_argnames=("self", "batch"))
    def _sim(self, key, batch: int):
        geom = self.geom
        eta = jax.vmap(lambda k: _grf.rand_hermitian_half(k, geom))(
            jax.random.split(key, batch))
        maps = jnp.fft.irfft2(self._covsqrt_h * eta, s=geom.shape)
        return self.map_bandpowers(maps)

    def sim_bandpowers(self, key, batch: int):
        """(batch, nbins) binned auto bandpowers of ``batch`` fresh GRF
        sims: half-plane white noise -> covsqrt -> irfft2 (the maps) ->
        :meth:`map_bandpowers`. ``key`` is a JAX PRNG key or an int
        seed."""
        if self._covsqrt_h is None:
            raise ValueError("construct FastCl with (ells, cl1d) to sim")
        if isinstance(key, (int, np.integer)):
            key = jax.random.PRNGKey(key)
        return self._sim(key, batch)

    @partial(jax.jit, static_argnames=("self",))
    def cross_bandpowers(self, maps1, maps2, window=None):
        """(B, nbins) binned cross spectra Re(x_hat conj(y_hat)) of two
        real map sets (B, ny, nx) (a single pair is B = 1). An optional
        ``window`` (ny, nx) apodization multiplies both sets first;
        debias the result by the window's w2 factor yourself."""
        m1 = jnp.asarray(maps1, jnp.float32)
        m2 = jnp.asarray(maps2, jnp.float32)
        if m1.ndim == 2:
            m1, m2 = m1[None], m2[None]
        if m1.shape != m2.shape:
            raise ValueError(f"map sets must match: {m1.shape} vs "
                             f"{m2.shape}")
        if window is not None:
            w = jnp.asarray(window, jnp.float32)
            m1, m2 = m1 * w, m2 * w
        return self._binned_power(jnp.fft.rfft2(m1), jnp.fft.rfft2(m2))

    @partial(jax.jit, static_argnames=("self",))
    def map_bandpowers(self, maps):
        """(B, nbins) binned auto power spectra of real maps (B, ny, nx) —
        FourierCalc.power2d + bin2D per map (a single map is B = 1)."""
        maps = jnp.asarray(maps, jnp.float32)
        if maps.ndim == 2:
            maps = maps[None]
        k = jnp.fft.rfft2(maps)
        return self._binned_power(k, k)
