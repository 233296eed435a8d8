"""Flat-sky map geometry as pure data.

JAX replacement for the ``(shape, wcs)`` pairs + ``pixell.enmap``
geometry calculus that the reference builds on (see reference
``orphics/maps.py:1472`` ``rect_geometry`` and the enmap methods
``modlmap/lmap/posmap/modrmap/pixsizemap`` used throughout).

Design: a :class:`Geometry` is a small immutable record of static integers
and floats (so it is a *static* argument under ``jax.jit`` — every derived
grid is a compile-time constant folded into the XLA program). All derived
grids are pure functions of it, returned as device arrays.

Conventions:
  * maps are ``(..., ny, nx)`` row-major, y = declination-like axis.
  * pixel sizes ``dy, dx`` are in radians.
  * Fourier wavenumbers ``ly, lx = 2*pi*fftfreq(n, d)`` (angular multipole
    per flat-sky convention), matching ``enmap.laxes``.
  * grid centers: pixel ``(i, j)`` sits at ``((i-(ny-1)/2)*dy,
    (j-(nx-1)/2)*dx)`` relative to patch center.
"""
from __future__ import annotations

import dataclasses
import math
import numpy as np
import jax.numpy as jnp

arcmin = np.pi / (180.0 * 60.0)
degree = np.pi / 180.0

__all__ = [
    "Geometry",
    "rect_geometry",
    "arcmin",
    "degree",
]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Immutable flat-sky patch geometry.

    Attributes
    ----------
    ny, nx : int
        Grid dimensions (rows, cols).
    dy, dx : float
        Pixel extent in radians along y (dec) and x (RA).
    y0 : float
        Declination of the patch center in radians (used only for the
        optional CAR-like spherical corrections; 0 for the equatorial
        patches the reference defaults to).
    """

    ny: int
    nx: int
    dy: float
    dx: float
    y0: float = 0.0

    # ----- scalars -------------------------------------------------
    @property
    def shape(self):
        return (self.ny, self.nx)

    @property
    def npix(self) -> int:
        return self.ny * self.nx

    @property
    def pixsize(self) -> float:
        """Pixel solid angle in steradians (flat approximation)."""
        return abs(self.dy * self.dx)

    @property
    def area(self) -> float:
        """Patch area in steradians (flat approximation).

        Mirrors ``enmap.area(shape, wcs)`` used for the physical FFT
        normalizations (reference ``orphics/maps.py:1605``).
        """
        return self.npix * self.pixsize

    @property
    def extent(self):
        """(height, width) of the patch in radians."""
        return (self.ny * abs(self.dy), self.nx * abs(self.dx))

    def lmax(self) -> float:
        """Largest |l| representable on the grid (corner of the l-plane)."""
        lymax = math.pi / abs(self.dy)
        lxmax = math.pi / abs(self.dx)
        return math.hypot(lymax, lxmax)

    def ellmax_safe(self) -> float:
        """Nyquist along the more coarsely sampled axis."""
        return math.pi / max(abs(self.dy), abs(self.dx))

    def scaled(self, factor: int) -> "Geometry":
        """Geometry downgraded by an integer factor (pixel size grows)."""
        return Geometry(self.ny // factor, self.nx // factor,
                        self.dy * factor, self.dx * factor, self.y0)

    # ----- Fourier-plane grids -------------------------------------
    def laxes(self, dtype=jnp.float32):
        """1D angular wavenumbers along y and x: ``2*pi*fftfreq``."""
        ly = 2 * np.pi * np.fft.fftfreq(self.ny, d=self.dy)
        lx = 2 * np.pi * np.fft.fftfreq(self.nx, d=self.dx)
        return jnp.asarray(ly, dtype=dtype), jnp.asarray(lx, dtype=dtype)

    def lmap(self, dtype=jnp.float32):
        """(2, ny, nx) array of (ly, lx) per Fourier pixel (enmap.lmap)."""
        ly, lx = self.laxes(dtype)
        lyy = jnp.broadcast_to(ly[:, None], (self.ny, self.nx))
        lxx = jnp.broadcast_to(lx[None, :], (self.ny, self.nx))
        return jnp.stack([lyy, lxx])

    def modlmap(self, dtype=jnp.float32):
        """(ny, nx) |l| per Fourier pixel (enmap.modlmap)."""
        ly, lx = self.laxes(jnp.float64 if dtype == jnp.float64 else jnp.float32)
        return jnp.sqrt(ly[:, None] ** 2 + lx[None, :] ** 2).astype(dtype)

    # ----- host-precision (numpy float64) grids ---------------------
    # Binner construction and other host-side precomputes must use these:
    # on an x64-disabled runtime, ``modlmap(jnp.float64)`` silently
    # truncates to float32 (and warns), which can move pixels that land
    # exactly on a bin edge. These stay in numpy end-to-end.

    def laxes_np(self):
        ly = 2 * np.pi * np.fft.fftfreq(self.ny, d=self.dy)
        lx = 2 * np.pi * np.fft.fftfreq(self.nx, d=self.dx)
        return ly, lx

    def modlmap_np(self):
        """(ny, nx) |l| grid in numpy float64 (host; for binners)."""
        ly, lx = self.laxes_np()
        return np.hypot(ly[:, None], lx[None, :])

    def modlmap_r_np(self):
        """|l| on the rfft half-plane in numpy float64 (host)."""
        ly = 2 * np.pi * np.fft.fftfreq(self.ny, d=self.dy)
        lx = 2 * np.pi * np.fft.rfftfreq(self.nx, d=self.dx)
        return np.hypot(ly[:, None], lx[None, :])

    def modrmap_np(self):
        """(ny, nx) radius grid in numpy float64 (host; for binners)."""
        y = (np.arange(self.ny) - (self.ny - 1) / 2.0) * self.dy
        x = (np.arange(self.nx) - (self.nx - 1) / 2.0) * self.dx
        return np.hypot(y[:, None], x[None, :])

    def rlaxes(self, dtype=jnp.float32):
        """Wavenumbers for the rfft half-plane: full ly, half lx."""
        ly = 2 * np.pi * np.fft.fftfreq(self.ny, d=self.dy)
        lx = 2 * np.pi * np.fft.rfftfreq(self.nx, d=self.dx)
        return jnp.asarray(ly, dtype=dtype), jnp.asarray(lx, dtype=dtype)

    def modlmap_r(self, dtype=jnp.float32):
        """|l| on the rfft half-plane, shape (ny, nx//2+1)."""
        ly, lx = self.rlaxes(dtype)
        return jnp.sqrt(ly[:, None] ** 2 + lx[None, :] ** 2).astype(dtype)

    # ----- real-space grids ----------------------------------------
    def yaxis(self, dtype=jnp.float32):
        y = (np.arange(self.ny) - (self.ny - 1) / 2.0) * self.dy
        return jnp.asarray(y, dtype=dtype)

    def xaxis(self, dtype=jnp.float32):
        x = (np.arange(self.nx) - (self.nx - 1) / 2.0) * self.dx
        return jnp.asarray(x, dtype=dtype)

    def posmap(self, dtype=jnp.float32):
        """(2, ny, nx) array of (dec, ra) sky offsets from patch center."""
        y = self.yaxis(dtype) + self.y0
        x = self.xaxis(dtype)
        yy = jnp.broadcast_to(y[:, None], (self.ny, self.nx))
        xx = jnp.broadcast_to(x[None, :], (self.ny, self.nx))
        return jnp.stack([yy, xx])

    def modrmap(self, dtype=jnp.float32):
        """(ny, nx) angular distance from patch center (enmap.modrmap)."""
        y = self.yaxis(dtype)
        x = self.xaxis(dtype)
        return jnp.sqrt(y[:, None] ** 2 + x[None, :] ** 2).astype(dtype)

    def pixsizemap(self, dtype=jnp.float32):
        """(ny, nx) per-pixel solid angle with the CAR cos(dec) factor.

        Equivalent role to ``enmap.pixsizemap`` / the ``psizemap`` math in
        reference ``orphics/maps.py:1228-1238``.
        """
        dec = self.yaxis(jnp.float64) + self.y0
        psize = np.abs(self.dy * self.dx) * jnp.cos(dec)
        return jnp.broadcast_to(psize[:, None], (self.ny, self.nx)).astype(dtype)

    def pixmap(self, dtype=jnp.float32):
        """(2, ny, nx) integer pixel coordinate grids."""
        iy = jnp.broadcast_to(jnp.arange(self.ny, dtype=dtype)[:, None], (self.ny, self.nx))
        ix = jnp.broadcast_to(jnp.arange(self.nx, dtype=dtype)[None, :], (self.ny, self.nx))
        return jnp.stack([iy, ix])

    def sky2pix(self, coords):
        """Map (dec, ra) offsets (radians, array (2, ...)) to fractional pixels."""
        coords = jnp.asarray(coords)
        py = (coords[0] - self.y0) / self.dy + (self.ny - 1) / 2.0
        px = coords[1] / self.dx + (self.nx - 1) / 2.0
        return jnp.stack([py, px])

    def pix2sky(self, pix):
        pix = jnp.asarray(pix)
        y = (pix[0] - (self.ny - 1) / 2.0) * self.dy + self.y0
        x = (pix[1] - (self.nx - 1) / 2.0) * self.dx
        return jnp.stack([y, x])


def rect_geometry(width_deg=None, px_res_arcmin=0.5, height_deg=None,
                  width_arcmin=None, height_arcmin=None, y0_deg=0.0) -> Geometry:
    """Build a rectangular patch geometry.

    Same role as reference ``orphics/maps.py:1472`` ``rect_geometry`` (which
    wraps ``enmap.geometry``): a patch of the given width/height with square
    pixels of ``px_res_arcmin``.
    """
    if width_deg is not None:
        width_arcmin = width_deg * 60.0
    if height_deg is not None:
        height_arcmin = height_deg * 60.0
    if width_arcmin is None:
        raise ValueError("specify width_deg or width_arcmin")
    if height_arcmin is None:
        height_arcmin = width_arcmin
    nx = int(round(width_arcmin / px_res_arcmin))
    ny = int(round(height_arcmin / px_res_arcmin))
    d = px_res_arcmin * arcmin
    return Geometry(ny=ny, nx=nx, dy=d, dx=d, y0=y0_deg * degree)
