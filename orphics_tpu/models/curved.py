"""Curved-sky map operations built on the native SHT (``ops/sht.py``).

JAX replacements for the reference's ``pixell.curvedsky`` /
``healpy`` call sites:

* ``rand_map`` / ``rand_cmb_sim``   (reference ``orphics/maps.py:716,1052``)
* ``wfactor`` (SHT branch)          (``maps.py:936``)
* ``cosine_stitch`` / ``stitched_noise`` (``maps.py:967,975``)
* ``kspace_coadd_alms``             (``maps.py:1121``)
* ``modulated_noise_map``           (``maps.py:1155``)
* ``hp.smoothing``-style beam convolution (used throughout reference)
* real coordinate rotation for ``MapRotator``/``get_rotated_pixels``
  (``maps.py:1681,1738``) and analytic ``galactic_mask`` (``maps.py:1186``)

All sphere fields live on :class:`orphics_tpu.ops.sht.RingGeom` grids
(iso-latitude rings, dense ``(ntheta, nphi)`` arrays); alms use healpy
packing.
"""
from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import Geometry
from ..ops import sht
from ..ops.sht import RingGeom
from ..ops import alm as almops

__all__ = [
    "synalm_matrix", "rand_map", "rand_cmb_sim", "smoothing",
    "wfactor", "masked_cls", "cosine_stitch", "stitched_noise",
    "kspace_coadd_alms", "white_noise", "modulated_noise_map",
    "gal2equ_rotation", "pointing_rotation", "rotate_map", "MapRotator",
    "galactic_mask", "pixsize_map", "get_rotated_pixels",
    "cutout_gnomonic",
]


# ---------------------------------------------------------------------------
# Correlated alm synthesis
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("lmax",))
def synalm_matrix(key, ps, lmax: int):
    """Draw correlated alms from a spectra matrix ``ps`` of shape
    ``(nc, nc, nl)`` (reference ``cs.rand_map``'s ps input, built by
    ``cmb_ps`` at ``orphics/maps.py:1038``).

    Uses the symmetric PSD square root per l (eigh with eigenvalue clamp),
    robust to zero rows (e.g. BB = 0).
    Returns ``(nc, nalm)`` complex alms.
    """
    ps = jnp.asarray(ps)
    nc = ps.shape[0]
    nl = ps.shape[-1]
    mats = jnp.moveaxis(ps, -1, 0)            # (nl, nc, nc)
    mats = 0.5 * (mats + jnp.swapaxes(mats, -1, -2))
    evals, evecs = jnp.linalg.eigh(mats)
    root = jnp.einsum("lij,lj,lkj->lik", evecs,
                      jnp.sqrt(jnp.clip(evals, 0.0, None)), evecs)
    # pad/truncate to lmax+1
    if nl < lmax + 1:
        root = jnp.pad(root, ((0, lmax + 1 - nl), (0, 0), (0, 0)))
    else:
        root = root[: lmax + 1]
    keys = jax.random.split(key, nc)
    cdt = jnp.result_type(ps.dtype, jnp.complex64)
    unit = jnp.stack([almops.synalm(keys[i],
                                    jnp.ones(lmax + 1, ps.dtype),
                                    lmax=lmax, dtype=cdt)
                      for i in range(nc)])    # (nc, nalm), unit variance
    ls, _ = almops.lm_indices(lmax)
    mix = root[jnp.asarray(ls)]               # (nalm, nc, nc)
    return jnp.einsum("kij,jk->ik", mix, unit)


def rand_map(key, rings: RingGeom, ps, lmax: int, pol: bool = None,
             nsims: int = None):
    """Curved-sky GRF realization (reference ``cs.rand_map`` role at
    ``orphics/maps.py:744``).

    ``ps`` is a 1D TT spectrum, or a ``(nc, nc, nl)`` matrix whose
    components are ordered T, E, B (pol synthesis via spin-2).
    Returns ``(ntheta, nphi)`` or ``(3, ntheta, nphi)``; with
    ``nsims`` an ensemble with a leading sims dim — the batched alm
    stacks share one l-recurrence.
    """
    ps = jnp.asarray(ps)
    if pol is not None and bool(pol) != (ps.ndim == 3 and ps.shape[0] == 3):
        raise ValueError(
            f"pol={pol} inconsistent with ps shape {ps.shape}: "
            "polarized synthesis needs a (3, 3, nl) T/E/B spectra "
            "matrix, spin-0 a 1D (or (1,1,nl)) spectrum")
    if nsims is not None:
        keys = jax.random.split(key, nsims)
        if ps.ndim == 1:
            alms = jax.vmap(lambda k: almops.synalm(
                k, ps, lmax=lmax,
                dtype=jnp.result_type(ps.dtype, jnp.complex64)))(keys)
            return sht.alm2map(alms, rings, lmax)
        alms = jax.vmap(lambda k: synalm_matrix(k, ps, lmax))(keys)
        if ps.shape[0] == 1:
            return sht.alm2map(alms[:, 0], rings, lmax)
        return sht.alm2map_pol(alms, rings, lmax)
    if ps.ndim == 1:
        a = almops.synalm(key, ps, lmax=lmax,
                          dtype=jnp.result_type(ps.dtype, jnp.complex64))
        return sht.alm2map(a, rings, lmax)
    alms = synalm_matrix(key, ps, lmax)
    if ps.shape[0] == 1:
        return sht.alm2map(alms[0], rings, lmax)
    return sht.alm2map_pol(alms, rings, lmax)


def rand_cmb_sim(key, rings: RingGeom, lmax: int, lensed=True, theory=None):
    """Lensed-CMB TQU sky (reference ``rand_cmb_sim``, ``maps.py:1052``)."""
    from .grf import cmb_ps
    from .theory import default_theory
    if theory is None:
        theory = default_theory()
    ps = cmb_ps(theory, lmax=lmax, lensed=lensed)
    return rand_map(key, rings, ps, lmax)


def smoothing(imap, rings: RingGeom, fwhm_arcmin: float, lmax: int):
    """Gaussian-beam smoothing on the sphere (healpy ``hp.smoothing`` /
    ``cs.filter`` role, reference ``maps.py:2979``)."""
    sigma = np.deg2rad(fwhm_arcmin / 60.0) / math.sqrt(8.0 * math.log(2.0))
    ell = jnp.arange(lmax + 1)
    bl = jnp.exp(-0.5 * ell * (ell + 1) * sigma ** 2)
    a = sht.map2alm(imap, rings, lmax)
    return sht.alm2map(almops.almxfl(a, bl), rings, lmax)


# ---------------------------------------------------------------------------
# Mask factors and masked spectra
# ---------------------------------------------------------------------------

def pixsize_map(rings: RingGeom):
    """Per-pixel solid angle of a ring grid (quadrature weight x dphi)."""
    w = jnp.asarray(rings.weights_array())
    return jnp.broadcast_to((w * (2 * np.pi / rings.nphi))[:, None],
                            rings.shape)


def wfactor(n: int, mask, rings: RingGeom = None, sht_norm: bool = True):
    """Mask power correction <mask^n> (reference ``wfactor``,
    ``maps.py:936``). With ``sht_norm`` the ratio is to the full-sky 4pi
    (SHT convention); otherwise to the mask's own area (FFT convention)."""
    mask = jnp.asarray(mask)
    if rings is None:
        return jnp.mean(mask ** n)
    pmap = pixsize_map(rings)
    tot = jnp.sum(mask ** n * pmap)
    return tot / (4 * np.pi) if sht_norm else tot / jnp.sum(pmap)


def masked_cls(alm, w2):
    """Mask-debiased pseudo-Cl (reference ``maps.py:1009``)."""
    return almops.alm2cl(alm) / w2


# ---------------------------------------------------------------------------
# Stitched noise (reference maps.py:967-1025)
# ---------------------------------------------------------------------------

def cosine_taper_ells(ls, lstart, lwidth):
    ls = jnp.asarray(ls, jnp.float64)
    fl = jnp.ones_like(ls)
    ramp = 1 - 0.5 * (1 - jnp.cos(-np.pi * (ls - lstart) / lwidth))
    fl = jnp.where(ls > lstart, ramp, fl)
    return jnp.where(ls > lstart + lwidth, 0.0, fl)


def cosine_stitch(alm1, map2, rings: RingGeom, lstitch, lcosine, mlmax):
    """Stitch a band-limited alm with a real-space map: alm1 tapers off
    above ``lstitch``; map2's large scales below are removed in quadrature
    (reference ``cosine_stitch``, ``maps.py:967``)."""
    ls = np.arange(mlmax + 1)
    fl1 = cosine_taper_ells(ls, lstitch, lcosine)
    fl2 = jnp.sqrt(jnp.clip(1.0 - fl1 ** 2, 0.0, None))
    alm1 = jnp.asarray(almops.change_alm_lmax(np.asarray(alm1), mlmax))
    a2 = sht.map2alm(jnp.asarray(map2), rings, mlmax)
    omap2 = jnp.asarray(map2) - sht.alm2map(
        almops.almxfl(a2, 1.0 - fl2), rings, mlmax)
    return sht.alm2map(almops.almxfl(alm1, fl1), rings, mlmax) + omap2


def white_noise(key, rings: RingGeom, rms_uk_arcmin, dtype=jnp.float64):
    """White-noise map with the given level in uK-arcmin on a ring grid
    (per-pixel sigma = Delta / sqrt(Omega_pix))."""
    rms = rms_uk_arcmin * np.pi / (180.0 * 60.0)
    sig = rms / jnp.sqrt(pixsize_map(rings))
    return jax.random.normal(key, rings.shape, dtype) * sig


def stitched_noise(key, rings: RingGeom, alm, mask, rms_uk_arcmin=None,
                   lstitch=None, lcosine=80, mlmax=None, alpha=-4,
                   flmin=700):
    """Stitch homogeneous white noise onto a band-limited noise sim
    (reference ``stitched_noise``, ``maps.py:975``). If the white level
    is not given it is fit from the red+white model of the input alm's
    masked spectrum, exactly as the reference does."""
    alm = np.asarray(alm)
    almax = almops.getlmax(alm.shape[-1])
    if mlmax is None:
        mlmax = min(almax + 800, 2 * almax)
    if lstitch is None:
        lstitch = almax - max(2 * lcosine, 100)
    mask = jnp.asarray(mask)
    bmask = mask > 0.5
    if rms_uk_arcmin is None:
        from scipy.optimize import curve_fit
        from .noise import rednoise
        w2 = float(wfactor(2, mask, rings))
        wcls = np.asarray(masked_cls(jnp.asarray(alm), w2))
        ls = np.arange(wcls.size)
        sel = ls > flmin
        rfunc = lambda l, rms, lknee: np.asarray(
            rednoise(l, rms, lknee=lknee, alpha=alpha))
        popt, _ = curve_fit(rfunc, ls[sel], wcls[sel], p0=[1e-3, 1000])
        rms = popt[0]
    else:
        rms = rms_uk_arcmin
    wmap = white_noise(key, rings, rms) * bmask
    omap = cosine_stitch(alm, wmap, rings, lstitch, lcosine, mlmax)
    return omap * bmask


def kspace_coadd_alms(alms, lbeams, nls, fkbeam=1.0):
    """Inverse-noise coadd in alm space (reference ``kspace_coadd_alms``,
    ``maps.py:1121``): weight_i = b_i f / N_i / sum_j b_j^2 / N_j."""
    lbeams = jnp.asarray(lbeams)
    nls = jnp.asarray(nls)
    denom = jnp.sum(lbeams ** 2 / nls, axis=0)
    weight = lbeams * fkbeam / nls / denom
    weight = jnp.nan_to_num(weight, nan=0.0, posinf=0.0, neginf=0.0)
    out = 0.0
    for i in range(len(alms)):
        out = out + almops.almxfl(alms[i], weight[i])
    return out


def modulated_noise_map(key, ivar, rings: RingGeom, lknee=None, alpha=None,
                        lmax=None, n_ell_standard=None):
    """Inhomogeneous 1/f-modulated noise sim (reference
    ``modulated_noise_map``, ``maps.py:1155``): a unit-spectrum GRF with
    the whitened N_ell, modulated by the per-pixel rms from ivar."""
    from .noise import atm_factor
    ivar = jnp.asarray(ivar)
    rms = jnp.where(ivar > 0, 1.0 / jnp.sqrt(jnp.maximum(ivar, 1e-30)), 0.0)
    if n_ell_standard is None and lknee is None:
        return jax.random.normal(key, rings.shape, rms.dtype) * rms
    if n_ell_standard is None:
        ells = np.arange(lmax + 1)
        n_ell_standard = np.nan_to_num(
            np.asarray(atm_factor(ells, lknee, alpha))) + 1.0
    smap = rand_map(key, rings, jnp.asarray(n_ell_standard),
                    lmax=len(np.asarray(n_ell_standard)) - 1)
    return rms * smap


# ---------------------------------------------------------------------------
# Coordinate rotation (real pointing math; replaces the flat-only
# round-1 MapRotator/galactic_mask)
# ---------------------------------------------------------------------------

# J2000 equatorial -> galactic rotation (IAU standard values);
# rows are the galactic basis vectors in equatorial coordinates.
_R_GAL = np.array([
    [-0.0548755604, -0.8734370902, -0.4838350155],
    [+0.4941094279, -0.4448296300, +0.7469822445],
    [-0.8676661490, -0.1980763734, +0.4559837762]])


def gal2equ_rotation(inverse=False):
    """3x3 rotation matrix taking GALACTIC unit vectors to equatorial,
    as the name says (``inverse=True`` gives equatorial -> galactic,
    i.e. the raw ``_R_GAL``)."""
    return _R_GAL if inverse else _R_GAL.T


def _ang2vec(dec, ra):
    cd = jnp.cos(dec)
    return jnp.stack([cd * jnp.cos(ra), cd * jnp.sin(ra), jnp.sin(dec)], -1)


def _vec2ang(v):
    dec = jnp.arcsin(jnp.clip(v[..., 2], -1.0, 1.0))
    ra = jnp.arctan2(v[..., 1], v[..., 0])
    return dec, ra


def pointing_rotation(center_source, center_target):
    """Rotation matrix mapping *target*-frame unit vectors to the
    *source* frame (the ``coordinates.recenter`` role in reference
    ``get_rotated_pixels``, ``maps.py:1738``): a vector at the target
    patch center lands on the source patch center — undo the target RA,
    rotate the dec difference about y, then apply the source RA."""
    decs, ras = center_source
    dect, rat = center_target

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    return rz(ras) @ ry(dect - decs) @ rz(-rat)


def _geom_posang(geom: Geometry, dtype=jnp.float64):
    """Absolute (dec, ra) of every pixel of a flat patch (small-patch
    cylindrical approximation consistent with ``Geometry``)."""
    iy = (jnp.arange(geom.ny, dtype=dtype) - (geom.ny - 1) / 2) * geom.dy
    ix = (jnp.arange(geom.nx, dtype=dtype) - (geom.nx - 1) / 2) * geom.dx
    dec = geom.y0 + iy
    return jnp.meshgrid(dec, ix, indexing="ij")


def get_rotated_pixels(geom_source: Geometry, geom_target: Geometry,
                       inverse=False, rot=None, source_ra0=0.0,
                       center_source=None, center_target=None):
    """Fractional source-pixel positions (2, ny, nx) of every target
    pixel after recentring the source patch onto the target patch
    (reference ``get_rotated_pixels``, ``maps.py:1738``). ``rot``
    overrides the recentring rotation; ``center_source``/
    ``center_target`` override the (dec, ra) patch centers otherwise
    taken from the geometries (Geometry carries the dec center as
    ``y0``; the source RA origin enters as ``source_ra0``).
    ``inverse`` swaps the sense of the recentring."""
    if rot is None:
        cs = ((geom_source.y0, source_ra0) if center_source is None
              else center_source)
        ct = ((geom_target.y0, 0.0) if center_target is None
              else center_target)
        if inverse:
            cs, ct = ct, cs
        rot = pointing_rotation(cs, ct)
    if isinstance(rot, jax.core.Tracer):
        # traced rotation: stay in jnp (accelerator fp32 — ~0.1 px noise)
        rot = jnp.asarray(rot, jnp.float64)
        dec_t, ra_t = _geom_posang(geom_target)
        v = _ang2vec(dec_t, ra_t)
        vs = jnp.einsum("ij,...j->...i", rot, v)
        dec_s, ra_s = _vec2ang(vs)
        ra_s = ra_s - source_ra0
        ra_s = jnp.arctan2(jnp.sin(ra_s), jnp.cos(ra_s))
        py = ((dec_s - geom_source.y0) / geom_source.dy
              + (geom_source.ny - 1) / 2)
        px = ra_s / geom_source.dx + (geom_source.nx - 1) / 2
        return jnp.stack([py, px])
    # concrete rotation (the common case): geometry-pair precompute on
    # the HOST in float64 — sub-1e-6-pixel positions even when the
    # device runs fp32; constant-folds into jitted consumers.
    rot = np.asarray(rot, np.float64)
    gt = geom_target
    iy = (np.arange(gt.ny) - (gt.ny - 1) / 2) * float(gt.dy) + float(gt.y0)
    ix = (np.arange(gt.nx) - (gt.nx - 1) / 2) * float(gt.dx)
    dec_t, ra_t = np.meshgrid(iy, ix, indexing="ij")
    v = np.stack([np.cos(dec_t) * np.cos(ra_t),
                  np.cos(dec_t) * np.sin(ra_t), np.sin(dec_t)], -1)
    vs = np.einsum("ij,...j->...i", rot, v)
    dec_s = np.arcsin(np.clip(vs[..., 2], -1.0, 1.0))
    ra_s = np.arctan2(vs[..., 1], vs[..., 0]) - source_ra0
    ra_s = np.arctan2(np.sin(ra_s), np.cos(ra_s))
    py = ((dec_s - float(geom_source.y0)) / float(geom_source.dy)
          + (geom_source.ny - 1) / 2)
    px = ra_s / float(geom_source.dx) + (geom_source.nx - 1) / 2
    return jnp.asarray(np.stack([py, px]))


@partial(jax.jit, static_argnames=("geom_source", "geom_target", "order",
                                   "source_ra0"))
def rotate_map(imap, geom_source: Geometry, geom_target: Geometry,
               rot=None, order=1, source_ra0=0.0):
    """Resample ``imap`` (on ``geom_source``) onto ``geom_target`` through
    a real spherical rotation (reference ``rotate_map``/``MapRotator``,
    ``maps.py:1780,1681``). ``rot`` is a 3x3 rotation matrix taking target
    coordinates to source coordinates; by default the recentering rotation
    between the two patch centers. ``source_ra0`` is the absolute RA of
    the source patch center (``Geometry`` encodes the dec center as
    ``y0`` but has no RA origin) — required whenever ``rot`` lands
    vectors at a nonzero source RA, e.g. ``MapRotatorEquator``.
    ``order``: 0 (nearest) or 1 (bilinear)."""
    from .mapstools import _bilinear_at
    if order not in (0, 1):
        raise NotImplementedError(
            "rotate_map implements order 0 (nearest) and 1 (bilinear); "
            "higher-order spline resampling is not available")
    pix = get_rotated_pixels(geom_source, geom_target, rot=rot,
                             source_ra0=source_ra0)
    py, px = pix[0], pix[1]
    if order == 0:
        py = jnp.round(py)
        px = jnp.round(px)
    return _bilinear_at(jnp.asarray(imap), py, px)


class MapRotator:
    """Rotate maps from one patch geometry to another through the proper
    spherical pointing transform (reference ``MapRotator``,
    ``maps.py:1681``)."""

    def __init__(self, geom_source: Geometry, geom_target: Geometry,
                 rot=None, source_ra0=0.0):
        self.geom_source = geom_source
        self.geom_target = geom_target
        self.rot = rot
        self.source_ra0 = float(source_ra0)

    def rotate(self, imap):
        return rotate_map(imap, self.geom_source, self.geom_target,
                          rot=self.rot, source_ra0=self.source_ra0)


def galactic_mask(geom: Geometry, theta1, theta2, coords="equ"):
    """Mask of the galactic colatitude strip [theta1, theta2], evaluated
    analytically on an equatorial patch (reference ``galactic_mask``,
    ``maps.py:1186``, which routes a healpix strip through a gal->equ
    spline reprojection — the strip boundary is exact here instead).

    Returns 1 outside the strip, 0 inside.
    """
    dec, ra = _geom_posang(geom)
    v = _ang2vec(dec, ra)
    if coords == "equ":
        vg = jnp.einsum("ij,...j->...i", jnp.asarray(_R_GAL), v)
    else:
        vg = v
    colat = jnp.arccos(jnp.clip(vg[..., 2], -1.0, 1.0))
    inside = (colat >= min(theta1, theta2)) & (colat <= max(theta1, theta2))
    return jnp.where(inside, 0.0, 1.0)


def galactic_mask_rings(rings: RingGeom, theta1, theta2, coords="equ"):
    """Same strip mask evaluated on a full-sky ring grid."""
    theta = jnp.asarray(rings.theta_array())
    phi = rings.phi0 + 2 * np.pi * jnp.arange(rings.nphi) / rings.nphi
    dec = np.pi / 2 - theta
    decg, rag = jnp.meshgrid(dec, phi, indexing="ij")
    v = _ang2vec(decg, rag)
    if coords == "equ":
        vg = jnp.einsum("ij,...j->...i", jnp.asarray(_R_GAL), v)
    else:
        vg = v
    colat = jnp.arccos(jnp.clip(vg[..., 2], -1.0, 1.0))
    inside = (colat >= min(theta1, theta2)) & (colat <= max(theta1, theta2))
    return jnp.where(inside, 0.0, 1.0)


def galactic_mask_equ(geom, theta1, theta2):
    """Galactic strip mask with colatitudes measured from the galactic
    equator (reference ``maps.py:1193``)."""
    return galactic_mask(geom, np.pi / 2.0 - theta1, np.pi / 2.0 - theta2)


def north_galactic_mask(geom):
    """Mask KEEPING the northern galactic hemisphere (reference
    ``maps.py:1197``): galactic_mask zeroes the given strip, so the
    strip to zero is the SOUTHERN colatitudes [90, 180] deg."""
    return galactic_mask(geom, np.deg2rad(90.0), np.deg2rad(180.0))


def south_galactic_mask(geom):
    """Mask KEEPING the southern galactic hemisphere (reference
    ``maps.py:1200``)."""
    return galactic_mask(geom, 0.0, np.deg2rad(90.0))


class MapRotatorEquator(MapRotator):
    """Rotate a map from a source geometry onto an equator-centered
    target patch (reference ``maps.py:1687``): the target geometry is
    built from the requested patch size, with the pixel size matched to
    the source's (optionally scaled by cos(max |dec|) of the source, the
    reference's recommended-pixel logic), then rotation proceeds as in
    :class:`MapRotator` via the pointing rotation that carries the
    source center to the target center.
    """

    def __init__(self, geom_source: Geometry, center_source,
                 patch_width_deg, patch_height_deg,
                 width_multiplier=1.0, height_multiplier=1.5,
                 pix_target_override_arcmin=None, downsample_pix_arcmin=None):
        from ..geometry import rect_geometry, arcmin as ARCMIN
        source_pix_arcmin = min(geom_source.dy, geom_source.dx) / ARCMIN
        if pix_target_override_arcmin is None:
            max_dec = abs(center_source[0]) + geom_source.ny \
                * geom_source.dy / 2.0
            pix = source_pix_arcmin * np.cos(min(max_dec, np.pi / 2.2))
        else:
            pix = pix_target_override_arcmin
        geom_target = rect_geometry(
            width_arcmin=patch_width_deg * 60.0 * width_multiplier,
            height_arcmin=patch_height_deg * 60.0 * height_multiplier,
            px_res_arcmin=pix)
        rot = pointing_rotation(center_source, (0.0, 0.0))
        # the rotation lands target vectors at the source's ABSOLUTE
        # RA; rotate_map must know that origin to form source pixels
        super().__init__(geom_source, geom_target, rot=rot,
                         source_ra0=center_source[1])
        self.downsample_pix_arcmin = downsample_pix_arcmin

    def rotate(self, imap):
        out = super().rotate(imap)
        if self.downsample_pix_arcmin is not None:
            from .mapstools import resample_fft
            from ..geometry import arcmin as ARCMIN
            out, _ = resample_fft(out, self.geom_target,
                                  self.downsample_pix_arcmin * ARCMIN)
        return out


def cutout_gnomonic(hp_map, rot=None, coord=None, xsize=200, ysize=None,
                    reso=1.5, nest=False, remove_dip=False,
                    remove_mono=False, gal_cut=0, flip="astro"):
    """Gnomonic (tangent-plane) cutout of a healpix map (reference
    ``cutout_gnomonic``, ``maps.py:2425`` — a healpy.gnomview
    derivative). Host-side viewer helper, numpy throughout.

    ``rot`` is (lon, lat[, psi]) in degrees placing that point at the
    cutout center with an extra ``psi`` rotation about the line of
    sight; ``coord`` of 'G'/'C' (or a pair rotating first->second)
    reinterprets the map's frame through the exact galactic<->equatorial
    rotation; ``reso`` is the pixel size in arcmin; ``flip='astro'``
    puts east on the left (the flip only mirrors the x axis — rows
    increase northward in both conventions, as in healpy's
    ``return_projected_map``). Sampling is nearest-pixel, as in healpy's
    projector; healpy UNSEEN sentinel values pass through unchanged.
    ``remove_mono``/``remove_dip`` subtract the monopole (and dipole)
    fitted over finite, non-UNSEEN pixels outside ``|b| < gal_cut``
    degrees."""
    hp_map = np.asarray(hp_map, np.float64)
    from ..utils import healpix as hpx
    nside = hpx.npix2nside(hp_map.size)

    if remove_dip or remove_mono:
        pix = np.arange(hp_map.size)
        th, ph = hpx.pix2ang(nside, hpx.nest2ring(nside, pix)
                             if nest else pix)
        # exclude healpy's UNSEEN sentinel (finite but ~-1.6e30) as
        # well as nan/inf from the fit, like healpy's mask_bad
        good = np.isfinite(hp_map) & (np.abs(hp_map) < 1e25)
        if gal_cut > 0:
            good &= np.abs(90.0 - np.degrees(th)) >= gal_cut
        v = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                      np.cos(th)], -1)
        if remove_dip:
            A = np.concatenate([np.ones((good.sum(), 1)), v[good]], 1)
            coef, *_ = np.linalg.lstsq(A, hp_map[good], rcond=None)
            hp_map = hp_map - coef[0] - v @ coef[1:]
        else:
            hp_map = hp_map - hp_map[good].mean()

    if ysize is None:
        ysize = xsize
    if rot is None:
        rot = (0.0, 0.0, 0.0)
    rot = tuple(np.atleast_1d(rot).astype(np.float64)) + (0.0, 0.0)
    lon0, lat0, psi = np.radians(rot[0]), np.radians(rot[1]), \
        np.radians(rot[2])

    # tangent-plane coordinates (radians); screen x rightward, y upward
    step = np.radians(reso / 60.0)
    xs = (np.arange(xsize) - (xsize - 1) / 2.0) * step
    ys = (np.arange(ysize) - (ysize - 1) / 2.0) * step
    X, Y = np.meshgrid(xs, ys)
    if flip == "astro":
        X = -X                       # east toward the left
    if psi != 0.0:
        c, s = np.cos(psi), np.sin(psi)
        X, Y = c * X - s * Y, s * X + c * Y

    # gnomonic inverse: direction = center + X e_east + Y e_north
    n_hat = np.array([np.cos(lat0) * np.cos(lon0),
                      np.cos(lat0) * np.sin(lon0), np.sin(lat0)])
    e_east = np.array([-np.sin(lon0), np.cos(lon0), 0.0])
    e_north = np.array([-np.sin(lat0) * np.cos(lon0),
                        -np.sin(lat0) * np.sin(lon0), np.cos(lat0)])
    d = (n_hat[None, None] + X[..., None] * e_east[None, None]
         + Y[..., None] * e_north[None, None])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    if coord is not None:
        coord = [coord] if isinstance(coord, str) else list(coord)
        if len(coord) == 2 and coord[0] != coord[1]:
            # directions are in the SECOND frame; pull back to the map's
            pair = (coord[0], coord[1])
            R = np.asarray(gal2equ_rotation(inverse=(pair == ("C", "G"))))
            if pair not in (("G", "C"), ("C", "G")):
                raise NotImplementedError(
                    "cutout_gnomonic supports G<->C rotations")
            d = d @ R                # R^T applied to row vectors
    theta = np.arccos(np.clip(d[..., 2], -1.0, 1.0))
    phi = np.arctan2(d[..., 1], d[..., 0]) % (2 * np.pi)
    pix = hpx.ang2pix(nside, theta.ravel(), phi.ravel())
    if nest:
        pix = hpx.ring2nest(nside, pix)
    # rows increase northward regardless of flip (healpy's projected-
    # map convention; display with origin='lower')
    return hp_map[pix].reshape(ysize, xsize)
