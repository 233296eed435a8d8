"""Grid-axis distributed Fourier analysis over a device mesh.

Maps too large for one device's HBM shard naturally over *rows* — this
module expresses the classic MPI "pencil/slab" FFT decomposition with
``shard_map`` + ``jax.lax.all_to_all`` over a named mesh axis (the
collective rides NVLink/NCCL on GPUs):

* :func:`fft2_dist` — distributed 2D FFT: local row FFTs, an
  ``all_to_all`` shard transpose, local column FFTs, and an optional
  transpose back. Exactly the pixell/FFTW-MPI slab strategy
  (reference ``orphics/maps.py`` delegates to enmap/pixell FFTs whose
  MPI counterpart is FFTW's ``fftw_mpi_plan_dft_2d``).
* :func:`masked_bandpowers_dist` — the end-to-end "masked spectra of a
  very large map" pipeline (window multiply -> distributed FFT ->
  half-plane-free |Z|^2 power -> radially binned bandpowers) with the
  map, window and binning tables all sharded over rows and only the
  final ``(nbins,)`` vector replicated (one ``psum``).
* :func:`lens_cov_dist` — the reference's row-parallel lensed
  pixel-pixel covariance MPI loop (``orphics/lensing.py:563-648``:
  rank-sharded rows of L U L^T) as sharded row batches: each device
  spline-lenses its block of covariance rows, and the row->column
  redistribution between the two one-sided applications is a sharded
  transpose (XLA inserts the all-to-all under jit from the sharding
  constraints).

All three compile on any mesh axis spec and are validated for exact
parity against their serial counterparts on the virtual CPU mesh
(tests/test_parallel.py::TestGridSharding), including a batch axis
sharded over ``sims`` *simultaneously* with rows over ``grid``.
"""
from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..geometry import Geometry
from ..ops.fourier import kfilter
from ..models.lensing import lens_map_spline

__all__ = ["fft2_dist", "ifft2_dist", "masked_bandpowers_dist",
           "lens_cov_dist"]


def _fft2_local(x, axis_name, inverse, back):
    """Per-shard body: x is (..., ny_local, nx) complex; the row axis is
    sharded over ``axis_name`` into S pieces (nx divisible by S)."""
    fft = jnp.fft.ifft if inverse else jnp.fft.fft
    z = fft(x, axis=-1)                                    # rows: local
    # shard transpose: (..., ny_l, nx) -> (..., ny, nx/S)
    z = jax.lax.all_to_all(z, axis_name, split_axis=z.ndim - 1,
                           concat_axis=z.ndim - 2, tiled=True)
    z = fft(z, axis=-2)                                    # cols: full
    if back:
        # return to row sharding: (..., ny, nx/S) -> (..., ny_l, nx)
        z = jax.lax.all_to_all(z, axis_name, split_axis=z.ndim - 2,
                               concat_axis=z.ndim - 1, tiled=True)
    return z


def _grid_specs(mesh: Mesh, axis: str, batch_axis, ndim: int):
    """PartitionSpec for (..., ny, nx) with rows on ``axis`` and the
    leading batch dim (if any) on ``batch_axis``."""
    lead = [None] * (ndim - 2)
    if batch_axis is not None and ndim > 2:
        lead[0] = batch_axis
    return P(*lead, axis, None)


@lru_cache(maxsize=64)
def _fft2_dist_fn(mesh: Mesh, axis: str, batch_axis, ndim: int,
                  inverse: bool):
    """Compiled-callable cache: jit keys on the callable object, so a
    fresh shard_map wrapper per call would re-trace/compile every
    invocation of a Monte-Carlo loop."""
    spec = _grid_specs(mesh, axis, batch_axis, ndim)
    fn = shard_map(
        partial(_fft2_local, axis_name=axis, inverse=inverse, back=True),
        mesh=mesh, in_specs=spec, out_specs=spec)
    return jax.jit(fn)


def fft2_dist(x, mesh: Mesh, axis: str = "grid", batch_axis=None,
              inverse: bool = False):
    """Distributed raw 2D FFT of row-sharded ``x`` (..., ny, nx).

    ``ny`` and ``nx`` must be divisible by the ``axis`` mesh size. The
    result is row-sharded the same way. ``batch_axis`` optionally
    shards a leading batch dimension over a second mesh axis.
    """
    x = jnp.asarray(x)
    fn = _fft2_dist_fn(mesh, axis, batch_axis, x.ndim, inverse)
    return fn(x.astype(jnp.result_type(x.dtype, jnp.complex64)))


def ifft2_dist(x, mesh: Mesh, axis: str = "grid", batch_axis=None):
    """Distributed raw inverse 2D FFT (see :func:`fft2_dist`)."""
    return fft2_dist(x, mesh, axis=axis, batch_axis=batch_axis,
                     inverse=True)


def masked_bandpowers_dist(maps, window, dig, nbins: int, norm,
                           mesh: Mesh, axis: str = "grid",
                           batch_axis=None):
    """Binned masked power spectra of very large row-sharded maps.

    Parameters
    ----------
    maps : (..., ny, nx) real, row-sharded over ``axis`` (and optionally
        batch-sharded over ``batch_axis``).
    window : (ny, nx) apodization, row-sharded the same way.
    dig : (ny, nx) int32 bin index per Fourier cell (0 = out of range,
        1..nbins in range — ``np.digitize`` against the bin edges of
        the *unshifted* fft2 modulus map), COLUMN-sharded (P(None,
        axis)): the power is consumed in the column-sharded layout the
        distributed FFT ends in.
    nbins : number of bins; norm : area/npix^2 power normalization.
    Returns (..., nbins) bandpower sums / counts, replicated.

    The whole pipeline — window, FFT rows, all_to_all, FFT cols,
    |Z|^2, one-hot bin matmul — is ONE shard_map program; the only
    cross-device data motions are ONE complex shard transpose and the
    final (nbins,) psum: the power is consumed in the column-sharded
    layout the distributed FFT naturally ends in (``dig`` enters
    column-sharded), so the transpose back to row sharding — half the
    collective traffic — is skipped entirely.
    """
    maps = jnp.asarray(maps)
    rdt = jnp.finfo(maps.dtype).dtype if maps.dtype != jnp.float64 \
        else jnp.float64
    fn = _masked_bp_fn(mesh, axis, batch_axis, maps.ndim, int(nbins),
                       str(jnp.dtype(maps.dtype)))
    return fn(maps, jnp.asarray(window, maps.dtype),
              jnp.asarray(dig, jnp.int32), jnp.asarray(norm, rdt))


@lru_cache(maxsize=64)
def _masked_bp_fn(mesh: Mesh, axis: str, batch_axis, ndim: int,
                  nbins: int, dtype_str: str):
    """Compiled-callable cache for :func:`masked_bandpowers_dist`
    (norm enters as a replicated scalar operand, not a closure)."""
    mdt = jnp.dtype(dtype_str)
    cdt = jnp.result_type(mdt, jnp.complex64)
    rdt = jnp.finfo(mdt).dtype if mdt != jnp.float64 else jnp.float64
    nseg = nbins + 1

    def body(m_l, w_l, dig_l, norm_l):
        # back=False: consume the power in the column-sharded layout
        # (..., ny, nx_l) the distributed FFT ends in — dig enters
        # column-sharded, and the second all_to_all never happens.
        z = _fft2_local((m_l * w_l).astype(cdt), axis, False, False)
        p = ((z.real ** 2 + z.imag ** 2)
             * norm_l.astype(rdt))                         # (..., ny, nx_l)
        oh = (dig_l[..., None] == jnp.arange(nseg)).astype(rdt)
        flat = p.reshape(p.shape[:-2] + (-1,))
        sums = flat @ oh.reshape(-1, nseg)                 # (..., nseg)
        cnts = oh.reshape(-1, nseg).sum(axis=0)
        sums = jax.lax.psum(sums, axis)
        cnts = jax.lax.psum(cnts, axis)
        return (sums[..., 1:] / jnp.maximum(cnts[1:], 1))

    mspec = _grid_specs(mesh, axis, batch_axis, ndim)
    wspec = P(axis, None)
    digspec = P(None, axis)                # column shard, matches back=False
    # output drops (ny, nx) for (nbins,): keep the batch placement
    lead = list(mspec)[:-2]
    ospec = P(*lead, None)
    fn = shard_map(body, mesh=mesh,
                   in_specs=(mspec, wspec, digspec, P()),
                   out_specs=ospec)
    return jax.jit(fn)


def lens_cov_dist(ucov, alpha, geom: Geometry, mesh: Mesh,
                  lens_order: int = 5, kbeam=None,
                  row_axes=("sims", "grid")):
    """Row-sharded lensed pix-pix covariance L U L^T (+ beam): the
    device-mesh version of the reference's MPI row loop
    (``orphics/lensing.py:563-648``, comm-rank strided rows).

    ``ucov`` is (npix, npix); rows shard over the flattened
    ``row_axes`` mesh axes (npix divisible by their product). Each
    one-sided application is embarrassingly parallel over rows; the
    transpose between them redistributes shards (XLA inserts the
    collective from the sharding constraints under jit).
    """
    ucov = jnp.asarray(ucov)
    alpha = jnp.asarray(alpha)
    one_side, beam_side, spec = _lens_cov_fns(mesh, tuple(row_axes),
                                              geom)
    cov = jax.device_put(ucov, spec)
    cov = one_side(cov, alpha, lens_order)
    cov = one_side(cov.T, alpha, lens_order)
    if kbeam is not None:
        kbeam = jnp.asarray(kbeam)
        cov = beam_side(cov.T, kbeam)
        cov = beam_side(cov.T, kbeam)
    return cov


@lru_cache(maxsize=32)
def _lens_cov_fns(mesh: Mesh, row_axes, geom: Geometry):
    """Compiled-callable cache for :func:`lens_cov_dist`."""
    spec = NamedSharding(mesh, P(row_axes, None))

    @partial(jax.jit, static_argnames=("order",), out_shardings=spec)
    def one_side(cov, alpha, order):
        rows = cov.reshape(-1, *geom.shape)
        out = jax.vmap(
            lambda m: lens_map_spline(m, alpha, geom, order=order))(rows)
        return out.reshape(cov.shape)

    @partial(jax.jit, out_shardings=spec)
    def beam_side(cov, kbeam):
        rows = cov.reshape(-1, *geom.shape)
        out = jax.vmap(lambda m: kfilter(m, kbeam, geom))(rows)
        return out.reshape(cov.shape)

    return one_side, beam_side, spec
