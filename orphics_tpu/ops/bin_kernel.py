"""Radial-bin sums as a Pallas kernel for NVIDIA GPUs (Triton route).

``bin_sums(data, ids, nseg)`` returns ``out[b, s] = sum_p data[b, p] *
[ids[p] == s]`` — the per-bin reduction behind :class:`Bin2D` and
:class:`RfftBin2D` (reference ``orphics/stats.py:786-797``,
``np.digitize`` + ``np.bincount``).

Each program owns a block of ``bm`` maps and a contiguous run of pixel
tiles. Per tile it loads the (bm, tile) data block and the tile's bin
ids once, builds the (tile, nseg) one-hot membership matrix from an iota
compare, and contracts the two on the tensor cores. The partial sums of
each program go to their own slot of a (programs, maps, nseg) buffer
that XLA sums afterwards: blocks run in no order on the GPU, so nothing
is accumulated across programs.

Precision: the one-hot factor is exact in bf16. The fp32 data is split
into three bf16 terms (hi, mid, lo; 8 mantissa bits each), each
contracted in fp32, smallest first. That carries all 24 bits of every
fp32 input, so the result is exact fp32 summation up to the order of
the additions — no TF32 rounding of the data.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["bin_sums"]

# Programs to aim for: a few waves over the H100's 132 SMs.
_TARGET_PROGRAMS = 528
# Block of maps x pixels per tensor-core contraction, and warps per
# program: the fastest of the shapes tried on an H100 at 192 x 2048 x 1025
# (PERF.md). Wider pixel tiles overflow the 227 KB of shared memory.
_BM, _TILE, _NUM_WARPS = 128, 256, 8


def _split3(x):
    """fp32 -> three bf16 terms whose fp32 sum is exactly ``x``."""
    hi = x.astype(jnp.bfloat16)
    r = x - hi.astype(jnp.float32)
    mid = r.astype(jnp.bfloat16)
    lo = (r - mid.astype(jnp.float32)).astype(jnp.bfloat16)
    return hi, mid, lo


def _kernel(x_ref, ids_ref, o_ref, *, nmaps, npix, bm, tile, nseg_pad,
            tiles_per_prog):
    i = pl.program_id(0)
    p = pl.program_id(1)
    rows = i * bm + jnp.arange(bm, dtype=jnp.int32)
    rmask = rows < nmaps
    seg = jnp.arange(nseg_pad, dtype=jnp.int32)

    def body(t, acc):
        c0 = pl.multiple_of((p * tiles_per_prog + t) * tile, tile)
        cols = c0 + jnp.arange(tile, dtype=jnp.int32)
        cmask = cols < npix
        ids = plgpu.load(ids_ref.at[pl.ds(c0, tile)], mask=cmask, other=-1)
        x = plgpu.load(x_ref.at[pl.ds(i * bm, bm), pl.ds(c0, tile)],
                       mask=rmask[:, None] & cmask[None, :], other=0.0)
        onehot = (ids[:, None] == seg[None, :]).astype(jnp.bfloat16)
        hi, mid, lo = _split3(x)
        acc = acc + pl.dot(lo, onehot)
        acc = acc + pl.dot(mid, onehot)
        return acc + pl.dot(hi, onehot)

    acc = lax.fori_loop(jnp.int32(0), jnp.int32(tiles_per_prog), body,
                        jnp.zeros((bm, nseg_pad), jnp.float32))
    plgpu.store(o_ref.at[p, pl.ds(i * bm, bm),
                         pl.ds(jnp.int32(0), nseg_pad)], acc,
                mask=rmask[:, None])


@functools.partial(jax.jit, static_argnames=("nseg", "interpret"))
def bin_sums(data, ids, nseg: int, interpret: bool = False):
    """Per-bin sums of ``data`` (..., npix) under bin ids ``ids`` (npix,)
    int32 in ``[0, nseg)``; ids outside that range are dropped.

    Returns (..., nseg) float32.
    """
    lead = data.shape[:-1]
    npix = data.shape[-1]
    x = data.reshape(-1, npix).astype(jnp.float32)
    nmaps = x.shape[0]
    bm = min(_BM, max(16, pl.next_power_of_2(nmaps)))
    tile = _TILE
    nseg_pad = max(16, pl.next_power_of_2(nseg))
    mblocks = pl.cdiv(nmaps, bm)
    ntiles = pl.cdiv(npix, tile)
    nprog = max(1, min(ntiles, _TARGET_PROGRAMS // mblocks))
    tiles_per_prog = pl.cdiv(ntiles, nprog)
    nprog = pl.cdiv(ntiles, tiles_per_prog)
    kernel = functools.partial(
        _kernel, nmaps=nmaps, npix=npix, bm=bm, tile=tile,
        nseg_pad=nseg_pad, tiles_per_prog=tiles_per_prog)
    partial_sums = pl.pallas_call(
        kernel,
        grid=(mblocks, nprog),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct((nprog, nmaps, nseg_pad),
                                       jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=2),
        interpret=interpret,
        name="bin_sums",
    )(x, ids.astype(jnp.int32))
    out = partial_sums.sum(axis=0)[:, :nseg]
    return out.reshape(lead + (nseg,))
