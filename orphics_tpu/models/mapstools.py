"""Remaining map-space toolkit: stacking/aperture photometry, matched
filters, pure-B purification, CG inpainting, power downsampling, beam
sanitization, gap filling, map rotation/rescaling, healpix thumbnails.

Covers the tail of the reference ``orphics/maps.py`` inventory (SURVEY
§2.1): ``flux`` (:2500), ``MatchedFilter`` (:2576), ``matched_filter``
(:677), ``FourierStack`` (:65), ``Purify``/``iqu_to_pure_lteb``
(:2624,2666), ``inpaint_cg`` (:2185), ``downsample_power`` (:1501),
``SymMat`` (:2882), ``sanitize_beam`` (:299), ``gapfill_edge_conv_flat``
(:819), ``cosine_taper``/``cosine_stitch`` (:960,967), ``MapRotator``
(:1681), ``diagonal_cov``/``ncov``/``pixcov`` maxlike block (:1792-1870),
``thumbnail_healpix`` (:614), ``galactic_mask`` (:1186), ``fsky``/``area``
(:1030-1037), ``analytical_tf`` (:89), ``minimum_ell`` (:363).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import Geometry, arcmin, degree
from ..ops import fourier as F
from ..ops.binning import Bin2D

__all__ = [
    "flux", "MatchedFilter", "matched_filter", "get_normalized_center",
    "FourierStack", "mask_center", "crop_center", "get_central", "Purify",
    "radial_window", "apodize_profile", "radial_mask", "circular_mask",
    "butterworth", "gauss_kern", "gkern_interp", "block_smooth",
    "field_variance", "random_source_map", "get_ecc", "filter_alms",
    "area_from_mask", "flat_sim", "resample_fft", "resampled_geometry",
    "split_sky", "cutup", "bounds_from_list", "spec1d_to_2d",
    "get_lnlike", "get_grf_cmb", "get_grf_realization", "rgeo",
    "resolution", "autofiltered_maps", "fourier_stack",
    "iqu_to_pure_lteb", "inpaint_cg", "analytical_tf", "minimum_ell",
    "cosine_taper", "downsample_power", "SymMat", "symmat_from_data",
    "sanitize_beam", "gapfill_edge_conv_flat", "binary_mask", "area",
    "fsky", "area_sqdeg", "rescale", "rotate", "MapRotator",
    "diagonal_cov", "ncov", "pixcov", "psizemap", "thumbnail_healpix",
    "galactic_mask",
    "convolve", "convolve_gaussian", "convolve_profile", "pixcov_sim",
    "get_planck_cutout",
    "generate_correlated_alm", "ftrans", "real_space_filter", "rfilter",
]


# ------------------------------------------------------------------
# stacking / aperture photometry / matched filtering
# ------------------------------------------------------------------

def flux(thumbs, aperture_radius, geom: Geometry, annulus_width=None,
         modrmap=None, pixsizemap=None):
    """Aperture photometry with annulus mean subtraction (reference
    ``orphics/maps.py:2500``), batched over leading dims."""
    thumbs = jnp.asarray(thumbs)
    if modrmap is None:
        modrmap = geom.modrmap(thumbs.dtype)
    if annulus_width is None:
        annulus_width = (np.sqrt(2.0) - 1.0) * aperture_radius
    if pixsizemap is None:
        pixsizemap = geom.pixsizemap(thumbs.dtype)
    ann = ((modrmap > aperture_radius)
           & (modrmap < aperture_radius + annulus_width))
    disk = modrmap <= aperture_radius
    wann = pixsizemap * ann
    num = jnp.sum(thumbs * wann, axis=(-2, -1))
    den = jnp.sum(wann)
    mean = (num / den)[..., None, None]
    return jnp.sum((thumbs - mean) * pixsizemap * disk, axis=(-2, -1))


class MatchedFilter:
    """Optimal amplitude of a known template in noisy data (reference
    ``orphics/maps.py:2576``): returns (amplitude, variance)."""

    def __init__(self, geom: Geometry, template=None, noise_power=None):
        self.geom = geom
        self.normfact = geom.area / geom.npix ** 2
        self.n2d = noise_power
        self.ktemp = (jnp.fft.fft2(jnp.asarray(template))
                      if template is not None else None)

    def apply(self, imap=None, kmap=None, template=None, noise_power=None,
              kmask=None):
        if kmap is None:
            kmap = jnp.fft.fft2(jnp.asarray(imap))
        ktemp = (self.ktemp if template is None
                 else jnp.fft.fft2(jnp.asarray(template)))
        n2d = self.n2d if noise_power is None else noise_power
        if kmask is None:
            kmask = 1.0
        in2d = jnp.nan_to_num(1.0 / jnp.asarray(n2d), posinf=0.0, neginf=0.0)
        phi_un = jnp.sum((ktemp.conj() * kmap).real
                         * self.normfact * kmask * in2d)
        phi_var = 1.0 / jnp.sum((ktemp.conj() * ktemp).real
                                * self.normfact * kmask * in2d)
        return phi_un * phi_var, phi_var


def matched_filter(kmap, ktemplate, n2d, geom: Geometry, kmask=None):
    """Functional matched filter on k-maps (reference
    ``orphics/maps.py:677``)."""
    mf = MatchedFilter(geom)
    mf.ktemp = ktemplate
    mf.n2d = n2d
    return mf.apply(kmap=kmap, kmask=kmask)


def get_normalized_center(geom: Geometry, dtype=jnp.float32):
    """Unit-integral delta at the patch center (reference
    ``orphics/maps.py:55``)."""
    t = jnp.zeros(geom.shape, dtype)
    return t.at[geom.ny // 2, geom.nx // 2].set(1.0 / geom.pixsize)


class FourierStack:
    """Bin kmap x conj(k-delta-template): radial Fourier-space stacking
    (reference ``orphics/maps.py:65``)."""

    def __init__(self, geom: Geometry, bin_edges):
        self.geom = geom
        self.binner = Bin2D(geom.modlmap_np(), bin_edges)
        temp = get_normalized_center(geom)
        self.ktemp = F.fft2(temp, geom, "phys")

    def apply(self, kmap):
        return self.binner.bin((kmap * self.ktemp.conj()).real)


def mask_center(imap):
    """NaN the central pixel(s) (reference ``orphics/maps.py:2601``;
    the reference asserts square maps — here each axis gets its own
    center so non-square maps are handled instead of silently masking
    the wrong row)."""
    imap = jnp.asarray(imap)
    ny, nx = imap.shape[-2], imap.shape[-1]
    cy, cx = ny // 2, nx // 2
    rows = [cy] if ny % 2 == 1 else [cy - 1, cy]
    cols = [cx] if nx % 2 == 1 else [cx - 1, cx]
    out = imap
    for r in rows:
        for c in cols:
            out = out.at[..., r, c].set(jnp.nan)
    return out


def crop_center(imap, ny, nx=None):
    nx = ny if nx is None else nx
    Ny, Nx = imap.shape[-2:]
    y0 = (Ny - ny) // 2
    x0 = (Nx - nx) // 2
    return imap[..., y0:y0 + ny, x0:x0 + nx]


def get_central(imap, frac):
    """Central fraction of a map (reference ``get_central``)."""
    if frac is None or frac == 1:
        return imap
    Ny, Nx = imap.shape[-2:]
    return crop_center(imap, int(Ny * frac), int(Nx * frac))


# ------------------------------------------------------------------
# pure-B purification (Smith estimator; reference maps.py:2624-2730)
# ------------------------------------------------------------------

def _fd_shift(a, dy, dx):
    return jnp.roll(a, (-dy, -dx), axis=(-2, -1))


def _deriv4(win, axis, delta):
    """4th-order centered finite difference along an axis (periodic)."""
    def sh(k):
        return jnp.roll(win, -k, axis=axis)
    return (-sh(2) + 8 * sh(1) - 8 * sh(-1) + sh(-2)) / (12.0 * delta)


def init_deriv_window(window, geom: Geometry):
    """Window derivatives for the pure-B estimator (reference
    ``orphics/maps.py:2640``)."""
    w = jnp.asarray(window)
    dx = _deriv4(w, -1, abs(geom.dx))
    dy = _deriv4(w, -2, abs(geom.dy))
    d2x = _deriv4(dx, -1, abs(geom.dx))
    d2y = _deriv4(dy, -2, abs(geom.dy))
    dxdy = _deriv4(dy, -1, abs(geom.dx))
    return dict(Win=w, dWin_dx=dx, dWin_dy=dy, d2Win_dx2=d2x,
                d2Win_dy2=d2y, d2Win_dxdy=dxdy)


def iqu_to_pure_lteb(tmap, qmap, umap, geom: Geometry, windict,
                     method: str = "pure", iau: bool = False):
    """(fT, fE, fB) with E->B leakage purification (Smith 2006 pure
    estimator; capability of reference ``orphics/maps.py:2666``).
    Input maps must already carry the window. Raw-fft outputs.

    Derivation in this framework's conventions (E + iB =
    e^{-2 i phi_l} fft(W (Q+iU)) with phi_l = atan2(lx, ly)): with the
    spin-lowering operator D = d/dy - i d/dx one has
    D^2 e^{-il.x} = -l^2 e^{-2 i phi} e^{-il.x}, so integrating D^2 by
    parts off the plane wave onto (W P+) gives

      B_pure = B_std + (2i/l)[cos(phi) fft(U Wy - Q Wx)
                              - sin(phi) fft(Q Wy + U Wx)]
                     - (1/l^2) fft(U (Wyy - Wxx) - 2 Q Wxy)
      E_pure = E_std + (2i/l)[cos(phi) fft(Q Wy + U Wx)
                              + sin(phi) fft(U Wy - Q Wx)]
                     - (1/l^2) fft(Q (Wyy - Wxx) + 2 U Wxy)

    with Q, U the *unwindowed* fields (boundary terms vanish because the
    window and its gradient vanish at the mask edge). Validated by the
    E-only Monte-Carlo: the pure B power is ~5e3 times below the standard
    estimator's leakage (tests/test_mapstools.py).
    """
    ml = jnp.asarray(geom.modlmap_np())
    ml = jnp.where(ml < 1.0, 1.0, ml)
    _ly, _lx = geom.laxes_np()
    ang = jnp.asarray(np.arctan2(_lx[None, :], _ly[:, None]))  # atan2(lx, ly)
    if iau:
        ang = -ang
    c2, s2 = jnp.cos(2 * ang), jnp.sin(2 * ang)
    c1, s1 = jnp.cos(ang), jnp.sin(ang)

    fT = jnp.fft.fft2(tmap)
    fQ = jnp.fft.fft2(qmap)
    fU = jnp.fft.fft2(umap)
    fE = fQ * c2 + fU * s2
    fB = -fQ * s2 + fU * c2
    if method == "standard":
        return fT, fE, fB

    w = windict
    Wx, Wy = w['dWin_dx'], w['dWin_dy']
    Wxx, Wyy, Wxy = w['d2Win_dx2'], w['d2Win_dy2'], w['d2Win_dxdy']
    q = qmap / _safe(w['Win'])
    u = umap / _safe(w['Win'])
    fA = jnp.fft.fft2(q * Wy + u * Wx)   # A = Q Wy + U Wx
    fC = jnp.fft.fft2(u * Wy - q * Wx)   # C = U Wy - Q Wx
    fB = fB + (2.0j / ml) * (c1 * fC - s1 * fA) \
        - jnp.fft.fft2(u * (Wyy - Wxx) - 2.0 * q * Wxy) / ml ** 2
    if method == "hybrid":
        return fT, fE, fB
    fE = fE + (2.0j / ml) * (c1 * fA + s1 * fC) \
        - jnp.fft.fft2(q * (Wyy - Wxx) + 2.0 * u * Wxy) / ml ** 2
    return fT, fE, fB


def _safe(w):
    return jnp.where(jnp.abs(w) > 1e-8, w, 1.0)


class Purify:
    """Pure-B spectra estimator wrapper (reference ``orphics/maps.py:2624``).

    >>> pur = Purify(geom, window)
    >>> fT, fE, fB = pur.lteb_from_iqu(iqu * window)
    """

    def __init__(self, geom: Geometry, window):
        self.geom = geom
        self.windict = init_deriv_window(window, geom)

    def lteb_from_iqu(self, imap, method: str = "pure", iau: bool = False):
        return iqu_to_pure_lteb(imap[0], imap[1], imap[2], self.geom,
                                self.windict, method=method, iau=iau)


# ------------------------------------------------------------------
# CG inpainting (reference maps.py:2185)
# ------------------------------------------------------------------

@partial(jax.jit, static_argnames=("geom", "maxiter"))
def inpaint_cg(imap, rand_map, mask, power2d, geom: Geometry, eps=1e-8,
               maxiter=500):
    """Constrained-realization hole filling by conjugate-gradient Wiener
    solve (Thibaut Louis' algorithm; reference ``orphics/maps.py:2185``).

    mask is 1 in the *good* region; power2d must be nonzero to pixel scale.
    The CG loop is ``jax.scipy.sparse.linalg.cg`` — fully on device.
    """
    from jax.scipy.sparse.linalg import cg
    imap = jnp.asarray(imap)
    mask = jnp.asarray(mask)
    ipow = 1.0 / jnp.asarray(power2d)

    def cinv(x):
        return jnp.fft.ifft2(jnp.fft.fft2(x) * ipow).real

    bad = 1.0 - mask

    def Aop(x):
        return (bad * cinv(bad * x.reshape(geom.shape))).reshape(-1)

    b = -(bad * cinv(mask * (imap - rand_map))).reshape(-1)
    x, _ = cg(Aop, b, x0=b, tol=eps, maxiter=maxiter)
    x = x.reshape(geom.shape) + rand_map * bad
    return imap * mask + x * bad


# ------------------------------------------------------------------
# misc spectra utilities
# ------------------------------------------------------------------

def analytical_tf(geom: Geometry, kfilter, bin_edges):
    """Binned k-mask transfer function (reference ``orphics/maps.py:89``)."""
    binner = Bin2D(geom.modlmap_np(), bin_edges)
    return binner.bin(jnp.asarray(kfilter).astype(jnp.float64))


def minimum_ell(geom: Geometry) -> int:
    """Lowest nonzero |l| on the grid (reference ``orphics/maps.py:363``)."""
    ml = geom.modlmap_np()
    return int(ml[ml > 0].min())


def cosine_taper(ls, lstart, lwidth):
    """Low-pass cosine taper filter (reference ``orphics/maps.py:960``)."""
    ls = np.asarray(ls, dtype=float)
    fl = np.ones_like(ls)
    sel = ls > lstart
    fl[sel] = 1 - 0.5 * (1 - np.cos(-np.pi * (ls[sel] - lstart) / lwidth))
    fl[ls > lstart + lwidth] = 0
    return fl


def downsample_power(p2d, geom: Geometry, ndown=16, exp=None, fftshift=True):
    """Smooth a 2D power spectrum by block averaging (noise-model /
    empirical-covariance smoothing; reference ``orphics/maps.py:1501``)."""
    from .grf import eig_pow
    p = jnp.asarray(p2d)
    if ndown < 1:
        return p
    ny, nx = p.shape[-2:]
    if fftshift:
        p = jnp.fft.fftshift(p, axes=(-2, -1))
    by, bx = ny // ndown, nx // ndown
    trimmed = p[..., :by * ndown, :bx * ndown]
    low = trimmed.reshape(p.shape[:-2] + (by, ndown, bx, ndown)).mean(
        axis=(-3, -1))
    if exp is not None:
        if low.ndim == 4:  # (ncomp, ncomp, by, bx)
            stack = jnp.moveaxis(low, (0, 1), (-2, -1))
            low = jnp.moveaxis(eig_pow(stack, exp), (-2, -1), (0, 1))
        else:
            low = jnp.abs(low) ** exp * jnp.sign(low)
    # nearest-neighbour upsample back
    up = jnp.repeat(jnp.repeat(low, ndown, axis=-2), ndown, axis=-1)
    out = jnp.zeros_like(p)
    out = out.at[..., :by * ndown, :bx * ndown].set(up)
    # fill trimmed borders with edge values
    out = out.at[..., by * ndown:, :].set(out[..., by * ndown - 1:by * ndown, :])
    out = out.at[..., :, bx * ndown:].set(out[..., :, bx * ndown - 1:bx * ndown])
    if fftshift:
        out = jnp.fft.ifftshift(out, axes=(-2, -1))
    return out


class SymMat:
    """Upper-triangle storage of a symmetric (ncomp, ncomp, ...) matrix
    (reference ``orphics/maps.py:2882``)."""

    def __init__(self, ncomp, shape, data=None):
        self.ncomp = ncomp
        self.shape = shape
        ndat = ncomp * (ncomp + 1) // 2
        self.data = data if data is not None else np.empty((ndat,) + tuple(shape))

    def yx_to_k(self, y, x):
        if y > x:
            return self.yx_to_k(x, y)
        return y * self.ncomp + x - y * (y + 1) // 2

    def __getitem__(self, tup):
        y, x = tup
        return self.data[self.yx_to_k(y, x)]

    def __setitem__(self, tup, value):
        y, x = tup
        self.data[self.yx_to_k(y, x)] = value

    def to_array(self, sel=np.s_[...], flatten=False):
        oshape = (self.data[0].reshape(-1)[sel].shape if flatten
                  else self.data[0][sel].shape)
        out = np.empty((self.ncomp, self.ncomp) + oshape)
        for y in range(self.ncomp):
            for x in range(y, self.ncomp):
                d = self.data[self.yx_to_k(y, x)]
                d = d.reshape(-1) if flatten else d
                out[y, x] = d[sel]
                if x != y:
                    out[x, y] = out[y, x]
        return out


def symmat_from_data(data):
    ndat = data.shape[0]
    ncomp = int(0.5 * (np.sqrt(8 * ndat + 1) - 1))
    return SymMat(ncomp, data.shape[1:], data=data)


def sanitize_beam(ells, lbeam, sval=1e-3, verbose=False):
    """Normalize a beam and continue it with a matched Gaussian below
    ``sval`` (reference ``orphics/maps.py:299``)."""
    ells = np.asarray(ells)
    if ells[0] != 0 or not np.all(np.diff(ells) == 1):
        raise ValueError("ells must be 0..lmax with unit spacing")
    lbeam = np.asarray(lbeam, dtype=float) / lbeam[0]
    if sval is None:
        return lbeam
    low = np.where(lbeam < sval)[0]
    if low.size == 0:
        return lbeam
    i0 = int(low[0]) - 1
    oell, olb = ells[i0], lbeam[i0]
    theta2 = -(16.0 * np.log(2.0)) * np.log(olb) / oell ** 2
    theta_fwhm = np.degrees(np.sqrt(theta2)) * 60.0
    obeam = lbeam.copy()
    obeam[low] = np.asarray(F.gauss_beam(ells[low], theta_fwhm))
    return obeam


def gapfill_edge_conv_flat(imap, mask, geom: Geometry, ivar=None, alpha=-3,
                           edge_rad=1 * arcmin, rmin=2 * arcmin, tol=1e-8,
                           key=None):
    """Gapfill by masked convolution with an r^alpha profile prioritizing
    the hole edges (reference ``orphics/maps.py:819``). ``mask`` is True
    in BAD regions."""
    from ..ops.distance import distance_transform
    imap = jnp.asarray(imap)
    mask = jnp.asarray(mask).astype(bool)
    # centered radial profile (periodic)
    y = np.fft.fftfreq(geom.ny) * geom.ny * abs(geom.dy)
    x = np.fft.fftfreq(geom.nx) * geom.nx * abs(geom.dx)
    r = np.sqrt(y[:, None] ** 2 + x[None, :] ** 2)
    r = np.maximum(r, rmin)
    rprof = jnp.asarray((r / arcmin) ** alpha)
    lprof = jnp.fft.fft2(rprof)
    # weight = ring of good pixels at the mask edge (at least ~1.5 px wide
    # so coarse grids don't produce an empty ring)
    edge_rad = max(edge_rad, 1.6 * max(abs(geom.dy), abs(geom.dx)))
    edist = distance_transform(mask, abs(geom.dy), abs(geom.dx))
    weight = ((edist > 0) & (edist < edge_rad)).astype(imap.dtype)

    def conv(m):
        return jnp.fft.ifft2(lprof * jnp.fft.fft2(m)).real

    rhs = conv(weight * imap)
    div = conv(weight)
    div = jnp.maximum(div, jnp.max(div) * tol * 100)
    omap = rhs / div
    omap = jnp.where(mask, omap, imap)
    if ivar is not None:
        if key is None:
            key = jax.random.PRNGKey(0)
        n = jax.random.normal(key, geom.shape, imap.dtype) / jnp.sqrt(ivar)
        omap = jnp.where(mask, omap + n, omap)
    return omap


def binary_mask(mask, threshold=0.5):
    return (jnp.asarray(mask) > threshold).astype(jnp.float32)


def area(mask, geom: Geometry, threshold=0.5):
    """Unmasked area in steradians (reference ``orphics/maps.py:1033``)."""
    return float(jnp.sum(binary_mask(mask, threshold)
                         * geom.pixsizemap(jnp.float64)))


def fsky(mask, geom: Geometry, threshold=0.5):
    return area(mask, geom, threshold) / 4.0 / np.pi


def area_sqdeg(mask, geom: Geometry, threshold=0.5):
    return area(mask, geom, threshold) / degree ** 2


# ------------------------------------------------------------------
# interpolation-based map transforms
# ------------------------------------------------------------------

def _bilinear_at(imap, py, px):
    """Bilinear sample of (..., ny, nx) at fractional pixel coords."""
    ny, nx = imap.shape[-2:]
    y0 = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, ny - 2)
    x0 = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, nx - 2)
    ty = jnp.clip(py - y0, 0.0, 1.0)
    tx = jnp.clip(px - x0, 0.0, 1.0)
    eps = 1e-5  # tolerate roundoff at the exact boundary
    inside = (py >= -eps) & (py <= ny - 1 + eps) \
        & (px >= -eps) & (px <= nx - 1 + eps)

    def at(dy, dx):
        idx = (y0 + dy) * nx + (x0 + dx)
        flat = imap.reshape(imap.shape[:-2] + (-1,))
        return jnp.take(flat, idx.reshape(-1), axis=-1).reshape(
            imap.shape[:-2] + py.shape)

    out = (at(0, 0) * (1 - ty) * (1 - tx) + at(0, 1) * (1 - ty) * tx
           + at(1, 0) * ty * (1 - tx) + at(1, 1) * ty * tx)
    return jnp.where(inside, out, 0.0)


def rescale(imap, factor, geom: Geometry):
    """Zoom a thumbnail by ``factor`` keeping its shape — factor > 1
    MAGNIFIES, matching the reference (``orphics/maps.py:rescale``
    scales cdelt by factor and reprojects; a feature at pixel offset d
    moves to factor*d). Output pixel i samples source (i - c)/factor."""
    ny, nx = geom.shape
    cy, cx = (ny - 1) / 2.0, (nx - 1) / 2.0
    iy = (jnp.arange(ny) - cy) / factor + cy
    ix = (jnp.arange(nx) - cx) / factor + cx
    py = jnp.broadcast_to(iy[:, None], (ny, nx))
    px = jnp.broadcast_to(ix[None, :], (ny, nx))
    return _bilinear_at(jnp.asarray(imap), py, px)


def rotate(imap, angle, geom: Geometry):
    """Rotate a map about its center by ``angle`` radians (clockwise
    positive, reference ``orphics/maps.py:rotate``)."""
    ny, nx = geom.shape
    cy, cx = (ny - 1) / 2.0, (nx - 1) / 2.0
    yy = jnp.arange(ny)[:, None] - cy
    xx = jnp.arange(nx)[None, :] - cx
    c, s = jnp.cos(angle), jnp.sin(angle)
    py = c * yy - s * xx + cy
    px = s * yy + c * xx + cx
    return _bilinear_at(jnp.asarray(imap),
                        jnp.broadcast_to(py, (ny, nx)),
                        jnp.broadcast_to(px, (ny, nx)))


class MapRotator:
    """Recenter a source-geometry patch onto a target geometry by sky-
    coordinate lookup + bilinear interpolation (flat-sky version of
    reference ``orphics/maps.py:1681``)."""

    def __init__(self, geom_source: Geometry, geom_target: Geometry):
        self.gs = geom_source
        self.gt = geom_target
        pos = geom_target.posmap(jnp.float64)
        # recenter: target coords relative to its center land on source
        # coords relative to the source center
        rel = jnp.stack([pos[0] - geom_target.y0, pos[1]])
        src = jnp.stack([rel[0] + geom_source.y0, rel[1]])
        self.pix_target = geom_source.sky2pix(src)

    def rotate(self, imap):
        return _bilinear_at(jnp.asarray(imap), self.pix_target[0],
                            self.pix_target[1])


# ------------------------------------------------------------------
# maxlike covariance block (reference maps.py:1792-1870)
# ------------------------------------------------------------------

def diagonal_cov(power2d, geom: Geometry):
    """Dense pix-pix covariance of a diagonal (in Fourier) power — the
    block-circulant construction (reference ``orphics/maps.py:1792``)."""
    from .pixcov import ps2d_to_mat
    p = jnp.asarray(power2d)
    if p.ndim == 2:
        p = p[None, None]
    ncomp = p.shape[0]
    npx = geom.npix
    out = jnp.zeros((ncomp, ncomp, npx, npx))
    for i in range(ncomp):
        for j in range(ncomp):
            out = out.at[i, j].set(ps2d_to_mat(p[i, j], geom))
    return out


def ncov(geom: Geometry, noise_uk_arcmin):
    """White-noise pixel covariance (reference ``orphics/maps.py:1810``)."""
    var = (noise_uk_arcmin * arcmin) ** 2 / geom.pixsize
    return jnp.eye(geom.npix) * var


def pixcov(geom: Geometry, fourier_cov):
    """Pixel-pixel covariance from a general (ncomp, ncomp, ny, nx, ny,
    nx) Fourier-space covariance (reference ``orphics/maps.py:1817``):
    normalized inverse FFT over the first grid pair, unnormalized
    forward FFT over the second, times npix/area. For a Fourier-diagonal
    power use ``diagonal_cov`` (the fused block-circulant path)."""
    fc = jnp.asarray(fourier_cov, jnp.complex64)
    out = jnp.fft.ifft2(fc, axes=(-4, -3))
    out = jnp.fft.fft2(out, axes=(-2, -1)).real
    return out * (geom.npix / geom.area)


def psizemap(geom: Geometry, dtype=jnp.float64):
    """Map of per-pixel solid angles in steradians for the cylindrical
    geometry (reference ``orphics/maps.py:1228`` — exact
    |sin(dec+dy/2)-sin(dec-dy/2)|*dra areas, which ``Geometry.
    pixsizemap`` already computes natively)."""
    return geom.pixsizemap(dtype)


# ------------------------------------------------------------------
# healpix interop
# ------------------------------------------------------------------

def thumbnail_healpix(hp_map, ra_deg, dec_deg, width_arcmin=30.0,
                      px_res_arcmin=0.5):
    """Nearest-neighbour gnomonic-style thumbnail from a healpix RING map
    (reference ``thumbnail_healpix``/``cutout_gnomonic``,
    ``orphics/maps.py:614,2425``)."""
    from ..utils import healpix as hp
    hp_map = np.asarray(hp_map)
    nside = hp.npix2nside(hp_map.size)
    n = int(width_arcmin / px_res_arcmin)
    g = Geometry(n, n, px_res_arcmin * arcmin, px_res_arcmin * arcmin)
    pos = np.asarray(g.posmap(jnp.float64))
    dec0 = np.radians(dec_deg)
    ra0 = np.radians(ra_deg)
    dec = dec0 + pos[0]
    ra = ra0 + pos[1] / np.cos(dec0)
    pix = hp.ang2pix(nside, np.pi / 2 - dec.reshape(-1),
                     np.mod(ra.reshape(-1), 2 * np.pi))
    return hp_map[pix].reshape(n, n), g


def galactic_mask(geom: Geometry, nside, theta1, theta2):
    """Mask a colatitude strip (e.g. the galactic plane in galactic
    coords) projected onto a flat geometry (reference
    ``orphics/maps.py:1186``; identity rotation — coordinate rotation is
    the caller's concern)."""
    from ..utils import healpix as hp
    orig = np.ones(hp.nside2npix(nside))
    orig[hp.query_strip(nside, theta1, theta2)] = 0
    pos = np.asarray(geom.posmap(jnp.float64))
    theta = np.pi / 2 - pos[0].reshape(-1)
    phi = np.mod(pos[1].reshape(-1), 2 * np.pi)
    pix = hp.ang2pix(nside, theta, phi)
    return jnp.asarray(orig[pix].reshape(geom.shape))


def generate_correlated_alm(input_alm_f1, Clf1f1, Clf2f2, Clf1f2, key=None):
    """alm of a field correlated with an existing one per given spectra
    (reference ``orphics/maps.py:generate_correlated_alm``)."""
    from ..ops.alm import almxfl, synalm, getlmax
    Clf1f1 = np.asarray(Clf1f1)
    Clf1f2 = np.asarray(Clf1f2)
    Clf2f2 = np.asarray(Clf2f2)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.nan_to_num(Clf1f2 / Clf1f1)
    correlated = almxfl(jnp.asarray(input_alm_f1), jnp.asarray(ratio))
    ps_noise = Clf2f2 - np.nan_to_num(Clf1f2 ** 2 / Clf1f1)
    ps_noise[ps_noise < 0] = 0
    if key is None:
        key = jax.random.PRNGKey(0)
    lmax = getlmax(np.asarray(input_alm_f1).shape[-1])
    noise = synalm(key, jnp.asarray(ps_noise), lmax)
    return correlated + noise


def interpolate_grid(in_grid, in_y, in_x, out_y=None, out_x=None, kx=3,
                     ky=3, **kwargs):
    """Regular-grid spline interpolation (reference
    ``orphics/maps.py:interpolate_grid``; host-side scipy)."""
    from scipy.interpolate import RectBivariateSpline
    spl = RectBivariateSpline(np.asarray(in_y), np.asarray(in_x),
                              np.asarray(in_grid), kx=kx, ky=ky, **kwargs)
    if out_y is None and out_x is None:
        return spl
    return spl(np.asarray(out_y), np.asarray(out_x))


def ftrans(p2d, tfunc=jnp.log10):
    """fftshift + transform for visualizing 2D spectra (reference
    ``orphics/maps.py:ftrans``)."""
    return tfunc(jnp.fft.fftshift(jnp.asarray(p2d), axes=(-2, -1)))


def real_space_filter(kfilter):
    """Real-space kernel of a k-space filter (reference
    ``orphics/maps.py:real_space_filter``)."""
    k = jnp.asarray(kfilter).astype(jnp.complex64)
    return jnp.fft.ifftshift(jnp.fft.ifft2(k).real, axes=(-2, -1))


def rfilter(imap, kfilter=None, rfilt=None):
    """Filter by real-space convolution (periodic; reference
    ``orphics/maps.py:rfilter``)."""
    if rfilt is None:
        rfilt = real_space_filter(kfilter)
    kf = jnp.fft.fft2(jnp.fft.ifftshift(rfilt, axes=(-2, -1)))
    return jnp.fft.ifft2(jnp.fft.fft2(jnp.asarray(imap)) * kf).real


# ---------------------------------------------------------------------------
# Radial windows / kernels / masks (reference maps.py:505-600, 2736-2800,
# 2970)
# ---------------------------------------------------------------------------

def radial_window(r, r0, r1, window="kaiser", beta=6.0):
    """Taper smoothly from 1 (r <= r0) to 0 (r >= r1) (reference
    ``maps.py:505``). windows: kaiser | cosine | quintic."""
    r = jnp.asarray(r)
    x = jnp.clip((r - r0) / (r1 - r0), 0.0, 1.0)
    if window == "kaiser":
        from jax.scipy.special import i0
        w = i0(beta * jnp.sqrt(1.0 - x ** 2)) / i0(beta)
    elif window == "cosine":
        w = 0.5 * (1.0 + jnp.cos(jnp.pi * x))
    elif window == "quintic":
        w = 1.0 - (10.0 * x ** 3 - 15.0 * x ** 4 + 6.0 * x ** 5)
    else:
        raise ValueError('window must be "kaiser", "cosine" or "quintic"')
    return jnp.where(r <= r0, 1.0, jnp.where(r >= r1, 0.0, w))


def apodize_profile(thetas, profile, roll_start, roll_width,
                    window="kaiser", beta=6.0):
    """Taper a 1D radial profile to zero over [roll_start,
    roll_start + roll_width] (reference ``maps.py:547``)."""
    w = radial_window(jnp.asarray(thetas), roll_start,
                      roll_start + roll_width, window=window, beta=beta)
    return jnp.asarray(profile) * w


def radial_mask(geom: Geometry, roll_start, roll_width, window="kaiser",
                beta=6.0, dtype=jnp.float32):
    """Circular mask from the distance-to-center map (reference
    ``maps.py:581``): 1 inside ``roll_start`` (radians), tapering to 0
    over ``roll_width``."""
    return radial_window(geom.modrmap(dtype), roll_start,
                         roll_start + roll_width, window=window,
                         beta=beta).astype(dtype)


def circular_mask(geom: Geometry, center_pix, radius_rad, apo_deg=None,
                  smooth_fwhm_rad=None, dtype=jnp.float32):
    """Zero a disc of ``radius_rad`` around ``center_pix`` = (y, x),
    optionally cosine-apodized and/or beam-smoothed (reference
    ``maps.py:2970`` up to its coordinate conventions: centers are pixel
    coordinates here, not degrees)."""
    from ..ops import distance as D
    srcs = np.asarray(center_pix, np.float64).reshape(1, 2)
    mask = 1.0 - D.mask_srcs(geom, srcs, float(radius_rad))
    if apo_deg:
        mask = D.cosine_apodize(binary_mask(mask), geom, apo_deg)
    if smooth_fwhm_rad:
        fwhm_arcmin = float(smooth_fwhm_rad) * 180.0 * 60.0 / np.pi
        bl2d = F.gauss_beam(jnp.asarray(geom.modlmap_np()), fwhm_arcmin)
        mask = F.kfilter(jnp.asarray(mask, dtype), bl2d.astype(dtype),
                         geom)
    return jnp.asarray(mask, dtype)


def butterworth(ells, ell0, n):
    """Butterworth low-pass 1/(1 + (l/l0)^{2n}) (reference
    ``maps.py:1869``)."""
    return 1.0 / (1.0 + (jnp.asarray(ells) / ell0) ** (2.0 * n))


def gauss_kern(sigma_y, sigma_x, nsigma=5.0):
    """Normalized 2D Gaussian convolution kernel (reference
    ``maps.py:2736``); sigmas in pixels."""
    sy = int(nsigma * sigma_y)
    sx = int(nsigma * sigma_x)
    y = jnp.arange(-sy, sy + 1, dtype=jnp.float64)[:, None]
    x = jnp.arange(-sx, sx + 1, dtype=jnp.float64)[None, :]
    g = jnp.exp(-(x ** 2 / (2 * sigma_x ** 2)
                  + y ** 2 / (2 * sigma_y ** 2)))
    return g / g.sum()


def gkern_interp(geom: Geometry, rs, bprof, fwhm_guess_arcmin,
                 nsigma=20.0):
    """Normalized 2D kernel from a 1D radial profile, cropped to
    ~nsigma of the guess width (reference ``maps.py:2753``). ``rs`` in
    radians."""
    fwhm = fwhm_guess_arcmin * np.pi / (180.0 * 60.0)
    sigma = fwhm / np.sqrt(8.0 * np.log(2.0))
    ny, nx = geom.shape
    sy = int(nsigma * sigma / abs(geom.dy))
    sx = int(nsigma * sigma / abs(geom.dx))
    if ((ny % 2 == 0) == (sy % 2 == 1)):
        sy += 1
    if ((nx % 2 == 0) == (sx % 2 == 1)):
        sx += 1
    rmap = crop_center(jnp.asarray(geom.modrmap_np()), sy, sx)
    # fill_value=0 beyond the tabulated profile (reference
    # interp1d(..., fill_value=0)): a clamped last value would put a
    # constant pedestal under the whole kernel skirt
    g = jnp.interp(rmap.reshape(-1), jnp.asarray(rs),
                   jnp.asarray(bprof), left=0.0,
                   right=0.0).reshape(rmap.shape)
    return g / g.sum()


# ---------------------------------------------------------------------------
# Map utilities tail (reference maps.py:703, 759, 774, 1262-1320,
# 1366-1480, 1591, 1830, 2836-2880)
# ---------------------------------------------------------------------------

def block_smooth(imap, factor):
    """Block-average in ``factor`` x ``factor`` tiles and project back to
    the original pixelization (reference ``maps.py:703``)."""
    imap = jnp.asarray(imap)
    ny, nx = imap.shape[-2:]
    assert ny % factor == 0 and nx % factor == 0, (ny, nx, factor)
    down = imap.reshape(imap.shape[:-2]
                        + (ny // factor, factor, nx // factor, factor)
                        ).mean(axis=(-3, -1))
    return jnp.repeat(jnp.repeat(down, factor, axis=-2), factor, axis=-1)


def field_variance(cls):
    """Real-space variance sum (2l+1) C_l / 4pi (reference
    ``maps.py:759``)."""
    cls = jnp.asarray(cls)
    ells = jnp.arange(cls.shape[-1])
    return jnp.sum((2 * ells + 1) * cls / (4 * jnp.pi), axis=-1)


def random_source_map(key, geom: Geometry, nobj, fwhm=None, profile=None,
                      amps=None, dtype=jnp.float32):
    """Map of ``nobj`` point sources at uniform-random pixels, convolved
    with a Gaussian beam or a 1D profile (reference ``maps.py:774``,
    flat-sky: positions are uniform over the patch)."""
    import jax
    kpos, kamp = jax.random.split(jax.random.PRNGKey(key)
                                  if isinstance(key, int) else key)
    ny, nx = geom.shape
    pix = jax.random.randint(kpos, (nobj, 2), 0,
                             jnp.asarray([ny, nx])[None, :])
    if amps is None:
        amps = jnp.ones((nobj,), dtype)
    srcmap = jnp.zeros((ny, nx), dtype).at[pix[:, 0], pix[:, 1]].add(
        jnp.asarray(amps, dtype))
    if fwhm is not None:
        bl2d = F.gauss_beam(jnp.asarray(geom.modlmap_np()), fwhm)
        return F.kfilter(srcmap, bl2d.astype(dtype), geom)
    if profile is not None:
        rs, bprof = profile
        ker = spec1d_like_profile_k(geom, rs, bprof)
        return F.kfilter(srcmap, ker.astype(dtype), geom)
    return srcmap


def spec1d_like_profile_k(geom: Geometry, rs, bprof, dtype=jnp.float32):
    """k-space filter equal to the FFT of a radial real-space profile
    (helper for profile-convolved source maps)."""
    r2d = jnp.asarray(geom.modrmap_np())
    prof2d = jnp.interp(r2d.reshape(-1), jnp.asarray(rs),
                        jnp.asarray(bprof), right=0.0).reshape(r2d.shape)
    k = jnp.fft.fft2(jnp.fft.ifftshift(prof2d))
    return jnp.real(k).astype(dtype)


def get_ecc(img):
    """Eccentricity from central image moments (reference
    ``maps.py:1262``; computed natively instead of via skimage)."""
    img = np.asarray(img, np.float64)
    ny, nx = img.shape[-2:]
    y = np.arange(ny)[:, None]
    x = np.arange(nx)[None, :]
    m00 = img.sum()
    cy = (img * y).sum() / m00
    cx = (img * x).sum() / m00
    mu20 = (img * (y - cy) ** 2).sum() / m00
    mu02 = (img * (x - cx) ** 2).sum() / m00
    mu11 = (img * (y - cy) * (x - cx)).sum() / m00
    disc = np.sqrt(4.0 * mu11 ** 2 + (mu20 - mu02) ** 2)
    l1 = (mu20 + mu02) / 2.0 + disc / 2.0
    l2 = (mu20 + mu02) / 2.0 - disc / 2.0
    return np.sqrt(1.0 - l2 / l1)


def filter_alms(alms, lmin, lmax):
    """Top-hat multipole filter on packed alms (reference
    ``maps.py:1282``)."""
    from ..ops import alm as almops
    nalm_lmax = almops.getlmax(jnp.asarray(alms).shape[-1])
    ells = jnp.arange(nalm_lmax + 1)
    fl = ((ells >= lmin) & (ells <= lmax)).astype(jnp.float32)
    return almops.almxfl(alms, fl)


def area_from_mask(mask, geom: Geometry):
    """(area in sq deg, unmasked fraction) of a binary mask (the role of
    reference ``maps.py:1316``, implemented via the equal-area flat
    geometry rather than raising like the reference does)."""
    frac = float(fsky_frac(mask))
    return frac * geom.area * (180.0 / np.pi) ** 2, frac


def fsky_frac(mask, threshold=0.5):
    m = binary_mask(mask, threshold)
    return m.sum() / np.prod(m.shape[-2:])


def flat_sim(deg, px, lmax=6000, lensed=True, pol=False):
    """One-liner bundle for flat-sky sims (reference ``maps.py:1366``):
    returns (geom, modlmap, theory, MapGen)."""
    from . import theory as theory_mod
    from .grf import MapGen
    from ..geometry import rect_geometry
    geom = rect_geometry(width_deg=deg, px_res_arcmin=px)
    th = theory_mod.default_theory()
    ells = np.arange(min(lmax, th.lpad) + 1)
    cfun = th.lCl if lensed else th.uCl
    if pol:
        ps = np.zeros((3, 3, len(ells)))
        ps[0, 0] = cfun("TT", ells)
        ps[0, 1] = ps[1, 0] = cfun("TE", ells)
        ps[1, 1] = cfun("EE", ells)
        ps[2, 2] = cfun("BB", ells)
    else:
        ps = np.asarray(cfun("TT", ells))[None, None]
    return geom, jnp.asarray(geom.modlmap_np()), th, MapGen(geom, ps)


def resampled_geometry(geom: Geometry, res_rad):
    """Geometry covering the same patch at pixel size ``res_rad``
    (reference ``maps.py:1397``)."""
    ny = int(round(geom.ny * geom.dy / res_rad))
    nx = int(round(geom.nx * geom.dx / res_rad))
    return Geometry(ny, nx, res_rad, res_rad)


def resample_fft(imap, geom: Geometry, res_rad):
    """Fourier resampling to pixel size ``res_rad`` (reference
    ``maps.py:1383``): crop or zero-pad the Fourier plane, preserving
    the mean. Input must be periodic/windowed."""
    imap = jnp.asarray(imap)
    ogeom = resampled_geometry(geom, res_rad)
    ny, nx = imap.shape[-2:]
    oy, ox = ogeom.shape
    k = jnp.fft.fftshift(jnp.fft.fft2(imap), axes=(-2, -1))
    # crop-or-pad PER AXIS: anisotropic pixels can need a crop along
    # one axis and a pad along the other (a single branch produced
    # negative pad widths / silently wrapped slices)
    def fit_axis(kk, size_in, size_out, axis):
        # align the DC bins: after fftshift DC sits at n//2, and
        # ifftshift on the output expects it at size_out//2 — a
        # "centered" (n-m)//2 crop misplaces DC by one whenever the
        # parities differ
        cin, cout = size_in // 2, size_out // 2
        if size_out <= size_in:
            s0 = cin - cout
            sl = [slice(None)] * kk.ndim
            sl[axis] = slice(s0, s0 + size_out)
            return kk[tuple(sl)]
        p0 = cout - cin
        pads = [(0, 0)] * kk.ndim
        pads[axis] = (p0, size_out - size_in - p0)
        return jnp.pad(kk, pads)

    k = fit_axis(k, ny, oy, k.ndim - 2)
    k = fit_axis(k, nx, ox, k.ndim - 1)
    k = jnp.fft.ifftshift(k, axes=(-2, -1))
    out = jnp.fft.ifft2(k).real * (oy * ox) / (ny * nx)
    return out, ogeom


def split_sky(dec_width, num_decs, ra_width, dec_start=0.0, ra_start=0.0,
              ra_extent=90.0):
    """Tile the sky into boxes of roughly constant solid angle
    (reference ``maps.py:1404``); degrees in, list of [[dec0, ra0],
    [dec1, ra1]] boxes out."""
    boxes = []
    for yindex in range(num_decs):
        y0 = dec_start + yindex * dec_width
        y1 = dec_start + (yindex + 1) * dec_width
        cosfact = np.cos(np.deg2rad((y0 + y1) / 2.0))
        nx = int(ra_extent * cosfact / ra_width)
        for xindex in range(nx):
            x0 = ra_start + xindex * ra_width / cosfact
            x1 = ra_start + (xindex + 1) * ra_width / cosfact
            boxes.append(np.array([[y0, x0], [y1, x1]]))
    return boxes


def cutup(shape, numy, numx, pad=0):
    """Pixel bounding boxes tiling a map into numy x numx (optionally
    padded, clipped) blocks (reference ``maps.py:1446``)."""
    Ny, Nx = shape[-2:]
    pixs_y = np.linspace(0, Ny, num=numy + 1, endpoint=True)
    pixs_x = np.linspace(0, Nx, num=numx + 1, endpoint=True)
    boxes = np.zeros((numy * numx, 2, 2))
    boxes[:, 0, 0] = np.clip(np.tile(pixs_y[:-1], numx) - pad, 0, None)
    boxes[:, 1, 0] = np.clip(np.tile(pixs_y[1:], numx) + pad, None, Ny - 1)
    boxes[:, 0, 1] = np.clip(np.repeat(pixs_x[:-1], numy) - pad, 0, None)
    boxes[:, 1, 1] = np.clip(np.repeat(pixs_x[1:], numy) + pad, None,
                             Nx - 1)
    return boxes.astype(int)


def bounds_from_list(blist):
    """[dec0, ra0, dec1, ra1] degrees -> [[dec0, ra0], [dec1, ra1]]
    radians (reference ``maps.py:1465``)."""
    return np.array(blist).reshape((2, 2)) * np.pi / 180.0


def spec1d_to_2d(geom: Geometry, ps, dtype=jnp.float32):
    """1D spectrum painted on the 2D Fourier plane in physical units
    (reference ``maps.py:1591``: spec2flat divided by npix/area)."""
    ps = np.asarray(ps, np.float64)
    ells = np.arange(ps.shape[-1], dtype=np.float64)
    return F.interp1d_to_2d(ells, ps, geom, dtype=dtype)


def get_lnlike(covinv, instamp):
    """Gaussian chi^2 kernel v^T Cinv v of a flattened stamp (reference
    ``maps.py:1830``)."""
    vec = jnp.asarray(instamp).reshape(-1)
    return vec @ jnp.asarray(covinv) @ vec


def get_grf_realization(key, geom: Geometry, power2d):
    """One GRF realization from a 2D power plane in spectrum units —
    (ny, nx), (1, 1, ny, nx) or a full (ncomp, ncomp, ny, nx) matrix
    (reference ``maps.py:2844``)."""
    from .grf import MapGen, eig_pow
    p = jnp.asarray(power2d, jnp.float64)
    fac = geom.npix / geom.area
    if p.ndim == 2 or (p.ndim == 4 and p.shape[0] == 1):
        covsqrt = jnp.sqrt(jnp.maximum(p * fac, 0.0))
    else:
        stack = jnp.moveaxis(p * fac, (0, 1), (-2, -1))
        covsqrt = jnp.moveaxis(eig_pow(stack, 0.5), (-2, -1), (0, 1))
    if covsqrt.ndim == 2:
        covsqrt = covsqrt[None, None]
    import jax
    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    return MapGen(geom, covsqrt=jnp.asarray(covsqrt, jnp.float32)
                  ).get_map(key)


def get_grf_cmb(key, geom: Geometry, theory, spec):
    """GRF with a theory spectrum painted on this geometry's modlmap
    (reference ``maps.py:2836``: interp the 1D Cl onto modlmap and
    hand get_grf_realization the (1, 1, ny, nx) power plane)."""
    ml = geom.modlmap_np()
    lmax = int(ml.max())
    ells = np.arange(lmax + 1)
    cl = np.asarray(theory.gCl(spec, ells))
    ps2d = np.interp(ml, ells, cl, left=0.0, right=0.0)[None, None]
    return get_grf_realization(key, geom, ps2d)


def rgeo(degrees, pixarcmin, **kwargs):
    """rect_geometry(width_deg=degrees, px_res_arcmin=pixarcmin)
    (reference ``maps.py:2873``)."""
    from ..geometry import rect_geometry
    return rect_geometry(width_deg=degrees, px_res_arcmin=pixarcmin,
                         **kwargs)


def resolution(geom: Geometry):
    """Geometric-mean pixel size in radians (reference
    ``maps.py:2181``); sign-safe for CAR-style negative dy."""
    return float(np.sqrt(abs(geom.dy * geom.dx)))


def autofiltered_maps(imap, geom: Geometry, ivar=None, mask=None,
                      threshold=1e-8, apod_deg=1.5, grow_deg=1.5,
                      lxcut=10, lycut=10, lmin=None, lmax=None):
    """Quick-look filtered map + auto-generated mask (reference
    ``maps.py:16``): threshold the ivar into a mask, grow + apodize it,
    apply a plus-shaped k-space filter, zero the masked region."""
    from ..ops import distance as D
    imap = jnp.asarray(imap)
    if mask is None:
        bmask = (jnp.asarray(ivar) > threshold).astype(jnp.float32)
        grown = D.grow_mask(bmask, geom, np.deg2rad(grow_deg))
        mask = D.cosine_apodize(grown, geom, apod_deg)
    if (lxcut is not None) or (lycut is not None):
        kmask = F.mask_kspace(geom, lxcut=lxcut, lycut=lycut, lmin=lmin,
                              lmax=lmax)
        fmap = F.kfilter(mask * imap, kmask, geom)
    else:
        fmap = imap
    fmap = jnp.where(mask <= (1 - threshold), 0.0, fmap)
    return fmap, mask


def fourier_stack(kmap, bin_edges, geom: Geometry):
    """One-shot FourierStack.apply (reference ``maps.py:76``)."""
    return FourierStack(geom, bin_edges).apply(kmap)


def slice_from_box(geom: Geometry, box_rad, inclusive=False):
    """numpy slice selecting the pixels inside [[dec0, ra0], [dec1,
    ra1]] (radians, patch-centered coordinates) — the role of reference
    ``maps.py:1426`` for the flat Geometry."""
    box = np.asarray(box_rad)
    y0 = int(np.floor((box[0, 0] - geom.y0) / geom.dy
                      + (geom.ny - 1) / 2 + (0 if inclusive else 0.5)))
    y1 = int(np.floor((box[1, 0] - geom.y0) / geom.dy
                      + (geom.ny - 1) / 2 + (1 if inclusive else 0.5)))
    x0 = int(np.floor(box[0, 1] / geom.dx + (geom.nx - 1) / 2
                      + (0 if inclusive else 0.5)))
    x1 = int(np.floor(box[1, 1] / geom.dx + (geom.nx - 1) / 2
                      + (1 if inclusive else 0.5)))
    return np.s_[..., max(y0, 0):min(y1, geom.ny),
                 max(x0, 0):min(x1, geom.nx)]


# ------------------------------------------------------------------
# real-space convolution (reference maps.py:2785-2833)
# ------------------------------------------------------------------

def convolve(imap, kernel):
    """Linear ('same'-mode) real-space convolution of map(s) with a 2D
    kernel (reference ``orphics/maps.py:2795``): zero-padded
    FFT convolution (one fused fft/ifft pair) instead of the reference's
    scipy.signal direct loop; supports leading component axes."""
    imap = jnp.asarray(imap)
    kernel = jnp.asarray(kernel, imap.dtype)
    ny, nx = imap.shape[-2:]
    ky, kx = kernel.shape
    py, px = ny + ky - 1, nx + kx - 1
    fi = jnp.fft.rfft2(imap, s=(py, px))
    fk = jnp.fft.rfft2(kernel, s=(py, px))
    full = jnp.fft.irfft2(fi * fk, s=(py, px))
    # crop to scipy.signal.convolve(mode='same') alignment
    y0, x0 = (ky - 1) // 2, (kx - 1) // 2
    return full[..., y0:y0 + ny, x0:x0 + nx]


def convolve_gaussian(imap, geom: Geometry, fwhm_arcmin, nsigma=5.0):
    """Convolve with a real-space Gaussian beam kernel (reference
    ``orphics/maps.py:2813``)."""
    fwhm = fwhm_arcmin * arcmin
    sigma_y = fwhm / (np.sqrt(8.0 * np.log(2.0)) * abs(geom.dy))
    sigma_x = fwhm / (np.sqrt(8.0 * np.log(2.0)) * abs(geom.dx))
    return convolve(imap, gauss_kern(sigma_y, sigma_x, nsigma=nsigma))


def convolve_profile(imap, geom: Geometry, rs, bprof, fwhm_guess_arcmin,
                     nsigma=20.0):
    """Convolve with a kernel interpolated from a 1D radial profile
    (reference ``orphics/maps.py:2785``); ``rs`` in radians."""
    g = gkern_interp(geom, rs, bprof, fwhm_guess_arcmin, nsigma=nsigma)
    return convolve(imap, g)


def pixcov_sim(geom: Geometry, ps, nsims, key=None, mean_sub=True, pad=0):
    """Brute-force Monte-Carlo pixel-pixel covariance of GRF sims
    (reference ``orphics/maps.py:1840``): vmapped synthesis on padded
    geometry, center extraction, host covariance."""
    from . import grf as _grf
    import jax as _jax
    if key is None:
        key = _jax.random.PRNGKey(0)
    if pad > 0:
        g = Geometry(geom.ny + 2 * pad, geom.nx + 2 * pad, geom.dy,
                     geom.dx, geom.y0)
    else:
        g = geom
    mgen = _grf.MapGen(g, np.asarray(ps))
    keys = _jax.random.split(key, nsims)
    sims = _jax.vmap(mgen.get_map)(keys)          # (nsims[, ncomp], ny, nx)
    if mean_sub:
        sims = sims - sims.mean(axis=(-2, -1), keepdims=True)
    if pad > 0:
        sims = sims[..., pad:-pad, pad:-pad]
    X = np.asarray(sims).reshape(nsims, -1)
    return np.cov(X.T)


def get_planck_cutout(hp_map, ra_deg, dec_deg, arcmin_width, px=2.0,
                      arcmin_y=None):
    """Gnomonic cutout of a healpix map around (ra, dec) (reference
    ``orphics/maps.py:2417``; the reference rotates galactic->celestial —
    pass coordinates in the map's frame here)."""
    if arcmin_y is None:
        arcmin_y = arcmin_width
    thumb, g = thumbnail_healpix(hp_map, ra_deg, dec_deg,
                                 width_arcmin=max(arcmin_width, arcmin_y),
                                 px_res_arcmin=px)
    ny = int(arcmin_y / px)
    nx = int(arcmin_width / px)
    return crop_center(jnp.asarray(thumb), ny, nx)
