"""Euclidean distance transforms on device — mask growth & apodization.

The reference leans on pixell's compiled ``distance_transform`` /
``distance_from`` (Fortran) for ``grow_mask``/``cosine_apodize``/
``mask_srcs`` (``orphics/maps.py:1057-1095``). There is no cheap XLA
primitive for exact EDTs, so we use **jump flooding** (Rong & Tan 2006):
each pixel carries the coordinates of its nearest seed candidate, and
log2(n) rounds of 8-neighbour propagation at strides n/2, n/4, ..., 1
refine it. Every round is 9 static ``jnp.roll`` + ``where`` ops — fully
dense, fuses under jit, no gathers. 1+JFA (an extra stride-1 round) keeps
errors to a tiny fraction of a pixel, ample for apodization windows.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["distance_transform", "distance_from_mask_edge", "grow_mask",
           "cosine_apodize", "mask_srcs"]


@partial(jax.jit, static_argnames=("wrap",))
def distance_transform(seeds, dy: float = 1.0, dx: float = 1.0,
                       wrap: bool = False):
    """Distance (in units set by dy/dx) from each pixel to the nearest
    True pixel of ``seeds`` (ny, nx) boolean.

    ``wrap``: periodic boundaries (False clamps at edges).
    """
    seeds = jnp.asarray(seeds, dtype=bool)
    ny, nx = seeds.shape
    iy = jax.lax.broadcasted_iota(jnp.float32, (ny, nx), 0)
    ix = jax.lax.broadcasted_iota(jnp.float32, (ny, nx), 1)
    big = jnp.float32(1e30)
    # nearest-seed coordinate carriers; invalid marked by big
    py = jnp.where(seeds, iy, big)
    px = jnp.where(seeds, ix, big)

    def dist2(py_, px_):
        dyy = (py_ - iy) * dy
        dxx = (px_ - ix) * dx
        return jnp.where(py_ > 1e29, big, dyy * dyy + dxx * dxx)

    steps = []
    s = 1 << int(np.ceil(np.log2(max(ny, nx))))
    while s >= 1:
        steps.append(s)
        s //= 2
    steps.append(1)  # 1+JFA refinement round

    def shift(a, oy, ox, fill):
        out = jnp.roll(a, (oy, ox), axis=(0, 1))
        if not wrap:
            if oy > 0:
                out = out.at[:oy, :].set(fill)
            elif oy < 0:
                out = out.at[oy:, :].set(fill)
            if ox > 0:
                out = out.at[:, :ox].set(fill)
            elif ox < 0:
                out = out.at[:, ox:].set(fill)
        return out

    for s in steps:
        best = dist2(py, px)
        for oy in (-s, 0, s):
            for ox in (-s, 0, s):
                if oy == 0 and ox == 0:
                    continue
                cy = shift(py, oy, ox, big)
                cx = shift(px, oy, ox, big)
                if wrap:
                    # unwrap candidate coords to the nearest periodic image
                    cy = jnp.where(cy > 1e29, cy,
                                   cy + jnp.round((iy - cy) / ny) * ny)
                    cx = jnp.where(cx > 1e29, cx,
                                   cx + jnp.round((ix - cx) / nx) * nx)
                d = dist2(cy, cx)
                take = d < best
                py = jnp.where(take, cy, py)
                px = jnp.where(take, cx, px)
                best = jnp.minimum(best, d)
    return jnp.sqrt(dist2(py, px))


def distance_from_mask_edge(mask, dy=1.0, dx=1.0):
    """Distance of each *inside* (mask>0) pixel from the masked region
    (mask==0); 0 outside. The quantity pixell's ``distance_transform``
    supplies for apodization."""
    mask = jnp.asarray(mask) > 0
    d = distance_transform(~mask, dy, dx)
    return jnp.where(mask, d, 0.0)


def grow_mask(mask, geom, width_rad):
    """Grow the zero (masked) region of a binary mask by ``width_rad``
    (reference ``orphics/maps.py:1084``)."""
    d = distance_transform(jnp.asarray(mask) <= 0, abs(geom.dy), abs(geom.dx))
    return (d > width_rad).astype(jnp.float32)


def cosine_apodize(bmask, geom, width_deg):
    """Cosine-taper a binary mask over ``width_deg`` from its edges
    (reference ``orphics/maps.py:1092``)."""
    width = width_deg * np.pi / 180.0
    r = distance_from_mask_edge(bmask, abs(geom.dy), abs(geom.dx))
    x = jnp.clip(r / width, 0.0, 1.0)
    return 0.5 * (1 - jnp.cos(np.pi * x)) * (jnp.asarray(bmask) > 0)


def mask_srcs(geom, srcs_pix, radius_rad):
    """Zero out circles of ``radius_rad`` around source pixel coords
    (N, 2) (reference ``orphics/maps.py:1057``)."""
    seeds = jnp.zeros(geom.shape, bool)
    srcs_pix = jnp.asarray(srcs_pix).astype(jnp.int32)
    seeds = seeds.at[srcs_pix[:, 0], srcs_pix[:, 1]].set(True)
    d = distance_transform(seeds, abs(geom.dy), abs(geom.dx))
    return (d > radius_rad).astype(jnp.float32)
