"""Ring-distributed spherical-harmonic transforms over a device mesh.

The iso-latitude SHT decomposes naturally over *rings* — exactly the
strategy libsharp uses over MPI ranks, expressed here with
``shard_map`` + ``psum`` over a named mesh axis:

* **Analysis** (``map2alm_dist``): the quadrature is a sum over rings,
  so each device runs the full Wigner recursion for *its ring subset
  only* (the recursion cost scales with local T, cutting both FLOPs and
  memory per device) and contributes a partial (l, m) matrix; one
  ``psum`` over the ring axis completes the alm. The per-shard
  colatitudes enter as traced arrays (``_seed_mantissa_exp_traced``).
* **Synthesis** (``alm2map_dist``): embarrassingly parallel — alm is
  replicated, each device synthesizes its own ring rows, and the output
  stays sharded over rings (no collective at all).

Both compile under jit on any ``jax.sharding.Mesh`` axis and are
validated against the serial transforms on the virtual CPU mesh
(tests/test_parallel.py). The compiled shard_map program is cached per
(mesh, axis, rings, lmax, batch-rank, dtype) working set — a
Monte-Carlo loop re-invoking a transform hits the executable cache
instead of re-tracing.

Known limitation (scale): the traced-theta ``_lambda_scan`` branch
bakes the O(lmax^2) A/B/C recurrence tables into the program as
constants (the serial path feeds them as device arguments), so the
program grows by hundreds of MB around lmax ~ 4096 and its compile time
with it. Lifting the tables to replicated shard_map operands is the fix
when distributed transforms at that band limit are needed.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import sht

__all__ = ["map2alm_dist", "alm2map_dist",
           "map2alm_spin_dist", "pad_rings"]


def pad_rings(rings: sht.RingGeom, ndev: int):
    """Pad a ring geometry to a ring count divisible by ``ndev``:
    returns (theta, weights, npad) arrays with zero-weight rings at the
    south end (zero quadrature weight => exact no-ops in analysis)."""
    T = rings.ntheta
    Tpad = -(-T // ndev) * ndev
    theta = np.concatenate([rings.theta_array(),
                            np.full(Tpad - T, np.pi / 2)])
    w = np.concatenate([rings.weights_array(), np.zeros(Tpad - T)])
    return theta, w, Tpad - T


def _theta_dtype(rdt):
    return jnp.float64 if jnp.dtype(rdt) == jnp.float64 else jnp.float32


@lru_cache(maxsize=16)
def _map2alm_dist_fn(mesh: Mesh, axis: str, rings: sht.RingGeom,
                     lmax: int, nbatch: int, rdt_str: str):
    rdt = jnp.dtype(rdt_str)
    cdt = jnp.result_type(rdt, jnp.complex64)
    Lpad = -(-(lmax + 1) // sht._LBLOCK) * sht._LBLOCK

    def local(maps_l, theta_l, w_l):
        F = sht._ring_analysis(maps_l, rings, lmax)    # (..., Tl, M+1)
        G = F * w_l[..., :, None]
        batch = maps_l.shape[:-2]
        out0 = jnp.zeros(batch + (Lpad, lmax + 1), cdt)

        def contract(l_base, lam_blk, out, _):
            lam = lam_blk[:, 0]                        # (block, M+1, Tl)
            rows = jnp.einsum("lmt,...tm->...lm", lam, G,
                              precision=sht._EPREC).astype(cdt)
            return jax.lax.dynamic_update_slice_in_dim(out, rows, l_base,
                                                       axis=-2)

        mat = sht._lambda_scan(lmax, theta_l, (0,), rdt, contract,
                               out0, vary_axes=(axis,))
        return jax.lax.psum(mat, axis)

    spec_map = P(*([None] * nbatch), axis, None)
    fn = shard_map(local, mesh=mesh,
                   in_specs=(spec_map, P(axis), P(axis)),
                   out_specs=P(*([None] * nbatch), None, None))

    def run(maps, thetaj, wq):
        mat = fn(maps, thetaj, wq)
        return sht._mat2alm(mat[..., : lmax + 1, :], lmax)

    return jax.jit(run)


def map2alm_dist(maps, rings: sht.RingGeom, lmax: int, mesh: Mesh,
                 axis: str = "sims"):
    """Ring-distributed analysis: healpy-packed alm from (ntheta, nphi)
    maps sharded over ``mesh`` axis ``axis``.

    Each shard runs the Wigner recursion over its local rings only and
    the partial (l, m) matrices are psum-reduced over the ring axis.
    """
    ndev = mesh.shape[axis]
    theta, w, npad = pad_rings(rings, ndev)
    maps = jnp.asarray(maps)
    rdt = maps.dtype
    if npad:
        maps = jnp.concatenate(
            [maps, jnp.zeros(maps.shape[:-2] + (npad, maps.shape[-1]),
                             rdt)], axis=-2)
    wq = jnp.asarray(w, rdt) * (2.0 * np.pi / rings.nphi)
    thetaj = jnp.asarray(theta, _theta_dtype(rdt))
    fn = _map2alm_dist_fn(mesh, axis, rings, int(lmax), maps.ndim - 2,
                          str(rdt))
    return fn(maps, thetaj, wq)


@lru_cache(maxsize=16)
def _alm2map_dist_fn(mesh: Mesh, axis: str, rings: sht.RingGeom,
                     lmax: int, nbatch: int, cdt_str: str):
    cdt = jnp.dtype(cdt_str)
    rdt = np.zeros((), np.dtype(cdt_str)).real.dtype

    def local(theta_l, mat_l):
        Tl = theta_l.shape[0]
        batch = mat_l.shape[1:-1]
        acc0 = jnp.zeros(batch + (Tl, lmax + 1), cdt)

        def contract(l_base, lam_blk, out, a_blk):
            lam = lam_blk[:, 0]
            return out + jnp.einsum("lmt,l...m->...tm", lam, a_blk,
                                    precision=sht._EPREC)

        acc = sht._lambda_scan(lmax, theta_l, (0,), jnp.dtype(rdt),
                               contract, acc0, xs=mat_l,
                               vary_axes=(axis,))
        return sht._ring_synthesis(acc, rings, real=True).astype(rdt)

    mat_spec = P(*([None] * (nbatch + 2)))
    fn = shard_map(local, mesh=mesh, in_specs=(P(axis), mat_spec),
                   out_specs=P(*([None] * nbatch), axis, None))

    def run(alm, thetaj):
        mat = jnp.moveaxis(sht._alm2mat(alm, lmax), -2, 0)
        out = fn(thetaj, mat)
        return out[..., : rings.ntheta, :]

    return jax.jit(run)


def alm2map_dist(alm, rings: sht.RingGeom, lmax: int, mesh: Mesh,
                 axis: str = "sims"):
    """Ring-distributed synthesis: replicated alm -> map sharded over
    rings on ``mesh`` axis ``axis`` (no collectives — each device
    synthesizes its own rows). Returns the full gathered map."""
    ndev = mesh.shape[axis]
    theta, _w, _npad = pad_rings(rings, ndev)
    alm = jnp.asarray(alm)
    thetaj = jnp.asarray(theta, _theta_dtype(
        np.zeros((), np.dtype(str(alm.dtype))).real.dtype))
    fn = _alm2map_dist_fn(mesh, axis, rings, int(lmax), alm.ndim - 1,
                          str(alm.dtype))
    return fn(alm, thetaj)


@lru_cache(maxsize=16)
def _map2alm_spin_dist_fn(mesh: Mesh, axis: str, rings: sht.RingGeom,
                          lmax: int, nbatch: int, rdt_str: str,
                          spin: int):
    rdt = jnp.dtype(rdt_str)
    cdt = jnp.result_type(rdt, jnp.complex64)
    Lpad = -(-(lmax + 1) // sht._LBLOCK) * sht._LBLOCK

    def local(q_l, u_l, theta_l, w_l):
        # ONE shared ring-FFT preamble with the serial spin path
        # (phase/nphi conventions can never drift); the full-ring
        # quadrature weights it returns are discarded for the SHARDED
        # w_l of this device's rings.
        Fp, Fm, _ = sht._spin_ring_analysis(q_l, u_l, rings, lmax)
        Gp = Fp * w_l[..., :, None]
        Gm = Fm * w_l[..., :, None]
        batch = q_l.shape[:-2]
        out0 = jnp.zeros((2,) + batch + (Lpad, lmax + 1), cdt)

        def contract(l_base, lam_blk, out, _):
            ap = jnp.einsum("lmt,...tm->...lm", lam_blk[:, 0], Gp,
                            precision=sht._EPREC)
            am = jnp.einsum("lmt,...tm->...lm", lam_blk[:, 1], Gm,
                            precision=sht._EPREC)
            rows = jnp.stack([-0.5 * (ap + am),
                              0.5j * (ap - am)]).astype(cdt)
            return jax.lax.dynamic_update_slice_in_dim(out, rows, l_base,
                                                       axis=-2)

        mat = sht._lambda_scan(lmax, theta_l, (-spin, spin), rdt,
                               contract, out0, vary_axes=(axis,))
        return jax.lax.psum(mat, axis)

    spec_map = P(*([None] * nbatch), axis, None)
    fn = shard_map(local, mesh=mesh,
                   in_specs=(spec_map, spec_map, P(axis), P(axis)),
                   out_specs=P(*([None] * (nbatch + 1)), None, None))

    def run(qmap, umap, thetaj, wq):
        mat = fn(qmap, umap, thetaj, wq)[..., : lmax + 1, :]
        return sht._mat2alm(mat[0], lmax), sht._mat2alm(mat[1], lmax)

    return jax.jit(run)


def map2alm_spin_dist(qmap, umap, rings: sht.RingGeom, lmax: int,
                      mesh: Mesh, axis: str = "sims", spin: int = 2):
    """Ring-distributed spin-s analysis: (Q, U) maps sharded over rings
    -> (E, B) alms via per-shard Wigner recursions + one psum."""
    ndev = mesh.shape[axis]
    theta, w, npad = pad_rings(rings, ndev)
    qmap = jnp.asarray(qmap)
    umap = jnp.asarray(umap)
    rdt = qmap.dtype
    if npad:
        z = jnp.zeros(qmap.shape[:-2] + (npad, qmap.shape[-1]), rdt)
        qmap = jnp.concatenate([qmap, z], axis=-2)
        umap = jnp.concatenate([umap, z], axis=-2)
    wq = jnp.asarray(w, rdt) * (2.0 * np.pi / rings.nphi)
    thetaj = jnp.asarray(theta, _theta_dtype(rdt))
    fn = _map2alm_spin_dist_fn(mesh, axis, rings, int(lmax),
                               qmap.ndim - 2, str(rdt), int(spin))
    return fn(qmap, umap, thetaj, wq)
