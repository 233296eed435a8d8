"""Radial binning of 2D spectra — the hot reduction of every pipeline.

Replaces reference ``orphics/stats.py:782`` ``bin2D`` (``np.digitize`` +
``np.bincount``). The bin assignment of each Fourier pixel is a pure
function of the (static) geometry and bin edges, so it is precomputed
once on the host; the per-map reduction on device is one of three
strategies, all exact fp32 summation:

  * ``triton``: the Pallas GPU kernel :func:`~orphics_tpu.ops.bin_kernel.
    bin_sums` — reads each pixel once and contracts it against an
    in-register one-hot bin matrix on the tensor cores.
  * ``rowcum``: radial modulus maps are monotone along every row after
    one shared static column permutation (|l| is monotone in |lx| at
    fixed ly). Binning then becomes: permute columns (static gather) ->
    per-row cumulative sum -> take the cumsum at static per-row
    bin-boundary positions -> difference and reduce over rows. fp32 row
    cumsums span only one row (<= nx same-sign terms), keeping relative
    error at the 1e-6 level on 2048^2 grids. Needs a radial modulus map;
    other maps take the ``segment`` path.
  * ``segment``: ``jax.ops.segment_sum`` over sort-permuted data with
    ``indices_are_sorted=True``.

The default is ``_GPU_STRATEGY`` on GPU hosts (the fastest of the three in
the flat-sky bench step, see PERF.md) and ``rowcum`` elsewhere;
``ORPHICS_TPU_BIN`` overrides it. The ``triton`` kernel is chosen where
the program is lowered (``lax.platform_dependent``): a program lowered
for a CUDA device runs it, one lowered for any other device (a
CPU-placed pipeline on a GPU host) runs ``rowcum``, or ``segment`` on a
non-radial map. Per-bin means fold statically precomputed 1/count
weights.
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from .bin_kernel import bin_sums

__all__ = ["Bin2D", "RfftBin2D", "bin1d", "bin1D", "bin_in_annuli"]

STRATEGIES = ("triton", "rowcum", "segment")
_GPU_STRATEGY = "triton"


def _default_strategy():
    env = os.environ.get("ORPHICS_TPU_BIN")
    if env:
        return env
    return _GPU_STRATEGY if jax.default_backend() == "gpu" else "rowcum"


class _RadialSums:
    """Per-bin sums of data on a fixed modulus grid (shared machinery of
    :class:`Bin2D` and :class:`RfftBin2D`)."""

    def _setup(self, modmap, bin_edges, strategy):
        self.strategy = strategy or _default_strategy()
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown binning strategy {self.strategy!r}; "
                             f"choose one of {STRATEGIES}")
        modmap = np.asarray(modmap, dtype=np.float64)
        bin_edges = np.asarray(bin_edges, dtype=np.float64)
        self.bin_edges = bin_edges
        self.centers = (bin_edges[1:] + bin_edges[:-1]) / 2.0
        self.cents = self.centers  # reference-compatible alias
        self.nbins = len(bin_edges) - 1
        self._nseg = self.nbins + 2
        # dig in [0, nbins+1]; 0 and nbins+1 are out of range.
        dig = np.digitize(modmap.reshape(-1), bin_edges, right=True)
        self._dig = dig
        self._dig_dev = jnp.asarray(dig.astype(np.int32))
        # rowcum applies when one shared column permutation makes every
        # row of the modulus map non-decreasing: true for radial maps
        # (modlmap, modrmap) on regular grids.
        ny, nx = modmap.shape
        colperm = np.argsort(modmap.min(axis=0), kind="stable")
        rows_sorted = modmap[:, colperm]
        self._rowcum = bool(np.all(np.diff(rows_sorted, axis=1) >= 0))
        # the plain path: the strategy itself, or the triton kernel's
        # fallback off CUDA
        self._use_rowcum = self._rowcum and self.strategy != "segment"
        if self._use_rowcum:
            # count of elements <= edge per row (digitize right=True puts
            # v == edge into the lower bin, so side='right')
            pos = np.empty((ny, len(bin_edges)), dtype=np.int32)
            for y in range(ny):
                pos[y] = np.searchsorted(rows_sorted[y], bin_edges,
                                         side="right")
            self._colperm = jnp.asarray(colperm.astype(np.int32))
            self._pos = jnp.asarray(pos)
        else:
            perm = np.argsort(dig, kind="stable")
            self._perm = jnp.asarray(perm.astype(np.int32))
            self._sorted_ids = jnp.asarray(dig[perm].astype(np.int32))
        return modmap

    def _set_counts(self, counts):
        self.counts = counts
        safe = np.where(counts == 0, 1, counts)
        self._inv_counts = jnp.asarray(
            (1.0 / safe * (counts > 0)).astype(np.float32))

    def _kernel_sum(self, data2d):
        flat = data2d.reshape(data2d.shape[:-2] + (-1,))
        out = bin_sums(flat, self._dig_dev, self._nseg)
        return out[..., 1:-1].astype(data2d.dtype)

    def _rowcum_sum(self, data2d):
        """Scatter-free per-bin sums: column permute -> row cumsum ->
        static boundary gathers -> row reduce."""
        d = jnp.take(data2d, self._colperm, axis=-1)
        c = jnp.cumsum(d, axis=-1)
        zero = jnp.zeros(c.shape[:-1] + (1,), c.dtype)
        cpad = jnp.concatenate([zero, c], axis=-1)
        pos = jnp.broadcast_to(self._pos, data2d.shape[:-2] + self._pos.shape)
        at_edges = jnp.take_along_axis(cpad, pos.astype(jnp.int32), axis=-1)
        rowbin = at_edges[..., 1:] - at_edges[..., :-1]  # (..., ny, nbins)
        return rowbin.sum(axis=-2)

    def _segment_sum(self, data2d):
        flat = data2d.reshape(data2d.shape[:-2] + (-1,))
        s = jnp.take(flat, self._perm, axis=-1)
        return _batched_segment_sum(s, self._sorted_ids,
                                    self._nseg)[..., 1:-1]

    def _plain_sum(self, data2d):
        if self._use_rowcum:
            return self._rowcum_sum(data2d)
        return self._segment_sum(data2d)

    def sum(self, data2d):
        """Per-bin sums of ``data2d`` (leading batch dims OK)."""
        if self.strategy == "triton":
            return jax.lax.platform_dependent(
                data2d, cuda=self._kernel_sum, default=self._plain_sum)
        return self._plain_sum(data2d)


class Bin2D(_RadialSums):
    """Radial (annular) binner over a fixed 2D modulus map.

    Parameters
    ----------
    modmap : array (ny, nx)
        The modulus grid (``modlmap`` for spectra, ``modrmap`` for profiles).
    bin_edges : array (nbins+1,)
        Bin edges; semantics match ``np.digitize(..., right=True)`` as in
        the reference (values with ``edges[i-1] < v <= edges[i]`` fall in
        bin ``i-1``; values outside the edge range are dropped).
    strategy : one of :data:`STRATEGIES`, or None for the default.
    """

    def __init__(self, modmap, bin_edges, strategy: str = None):
        self._setup(modmap, bin_edges, strategy)
        self._set_counts(np.bincount(self._dig,
                                     minlength=self._nseg)[1:-1])

    def bin(self, data2d, weights=None):
        """Bin a 2D (or batch of 2D) array into annular means.

        Returns ``(centers, means)``; matches reference
        ``bin2D.bin`` (``orphics/stats.py:790-797``).
        """
        if weights is None:
            sums = self.sum(data2d)
            return self.centers, sums * self._inv_counts.astype(sums.dtype)
        w = jnp.broadcast_to(jnp.asarray(weights), data2d.shape[-2:])
        num = self.sum(data2d * w)
        den = self.sum(jnp.broadcast_to(w, data2d.shape))
        return self.centers, num / den

    def bin_err(self, data2d):
        """(centers, means, scatter-in-bin error) like the reference err path."""
        cents, means = self.bin(data2d)
        sq = self.sum(data2d * data2d) * self._inv_counts.astype(means.dtype)
        counts = jnp.asarray(np.maximum(self.counts, 2), dtype=means.dtype)
        var = (sq - means ** 2) * counts / (counts - 1.0)
        err = jnp.sqrt(jnp.maximum(var, 0.0) / counts)
        return cents, means, err


def _batched_segment_sum(data, ids, nseg):
    if data.ndim == 1:
        return jax.ops.segment_sum(data, ids, num_segments=nseg,
                                   indices_are_sorted=True)
    lead = data.shape[:-1]
    flat = data.reshape(-1, data.shape[-1])
    f = lambda v: jax.ops.segment_sum(v, ids, num_segments=nseg,
                                      indices_are_sorted=True)
    return jax.vmap(f)(flat).reshape(lead + (nseg,))


class RfftBin2D(_RadialSums):
    """Radial binner over the rfft half-plane that reproduces *full-plane*
    binning exactly for Hermitian-symmetric data (e.g. the power of a real
    map): half-plane sums carry multiplicity weight 2 except on the
    self-conjugate columns (lx=0 and the even-nx Nyquist column), and the
    divisor is the full-plane bin count.
    """

    def __init__(self, geom, bin_edges, strategy: str = None):
        # Host-f64 end to end: ``geom.modlmap(jnp.float64)`` silently
        # truncates to fp32 on an x64-off runtime (and warns), which can
        # move edge-collision pixels between bins. modlmap_np never
        # touches the device.
        full = geom.modlmap_np()
        half = full[:, :geom.nx // 2 + 1]
        self._setup(half, bin_edges, strategy)
        digf = np.digitize(full.reshape(-1), self.bin_edges, right=True)
        self._set_counts(np.bincount(digf, minlength=self._nseg)[1:-1])
        w = np.full(half.shape, 2.0, dtype=np.float32)
        w[:, 0] = 1.0
        if geom.nx % 2 == 0:
            w[:, -1] = 1.0
        self._w = jnp.asarray(w)

    def bin(self, data2d_half):
        """(centers, full-plane-equivalent bin means) from half-plane data."""
        sums = self.sum(data2d_half * self._w.astype(data2d_half.dtype))
        return self.centers, sums * self._inv_counts.astype(sums.dtype)


def bin1d(x, y, bin_edges):
    """Bin samples (x, y) into mean-per-bin; reference ``bin1D``
    (``orphics/stats.py:815``). Host-side numpy (used for theory curves)."""
    x = np.asarray(x)
    y = np.asarray(y)
    cents = (np.asarray(bin_edges)[1:] + np.asarray(bin_edges)[:-1]) / 2.0
    dig = np.digitize(x, bin_edges, right=True)
    nb = len(bin_edges) - 1
    sums = np.bincount(dig, weights=np.nan_to_num(y), minlength=nb + 2)[1:-1]
    cnts = np.bincount(dig[~np.isnan(y)], minlength=nb + 2)[1:-1]
    with np.errstate(invalid="ignore", divide="ignore"):
        means = sums / cnts
    return cents, means


class bin1D:
    """Reference-shaped 1D binner (``orphics/stats.py:815``): constructed
    with bin edges, ``bin(x, y, stat)`` returns (centers, binned). Host
    numpy via scipy ``binned_statistic`` — used for theory curves, not on
    the device hot path (that is :class:`Bin2D`)."""

    def __init__(self, bin_edges):
        self.update_bin_edges(bin_edges)

    def update_bin_edges(self, bin_edges):
        self.bin_edges = np.asarray(bin_edges)
        self.numbins = len(bin_edges) - 1
        self.cents = (self.bin_edges[:-1] + self.bin_edges[1:]) / 2.0
        self.bin_edges_min = self.bin_edges.min()
        self.bin_edges_max = self.bin_edges.max()

    def bin(self, ix, iy, stat=np.nanmean):
        from scipy.stats import binned_statistic
        x = np.asarray(ix).copy()
        y = np.asarray(iy).astype(float).copy()
        y[x < self.bin_edges_min] = 0
        y[x > self.bin_edges_max] = 0
        means = binned_statistic(x, y, bins=self.bin_edges,
                                 statistic=stat)[0]
        return self.cents, means


def bin_in_annuli(data2d, modrmap, bin_edges):
    """One-shot annular binning (reference ``orphics/stats.py:853``)."""
    binner = Bin2D(modrmap, bin_edges)
    return binner.bin(data2d)
