"""Pixel-pixel covariances for small stamps; maximum-likelihood inpainting.

JAX re-design of reference ``orphics/pixcov.py``: the brute-force
inpainting of circular holes (Eq 3 of arXiv:1109.0286). The reference
distributes an MPI loop over ~1e4 sources, each doing a dense
O((ncomp n^2)^3) inverse on one rank (``pixcov.py:520-693``); here the
per-source work is a pure function vmapped into one batched
inverse/solve/eigh program, and the per-map application phase
(mean infill + covsqrt draw) is a single batched matmul.

Math notes (matching the reference exactly):
  * the stamp covariance is block-circulant: C[p1, p2] = xi((x1-x2) mod n)
    with xi = raw_ifft(P2d * npix/area) (``pixcov.py:21-38,87-102``);
  * IQU ordering is component-major blocks (``pixcov.py:243``);
  * the common mode of each component is deprojected with a Woodbury
    correction (``pixcov.py:249-253``);
  * hole pixels m1, context m2; mean infill = -Cinv[m1,m1]^{-1} Cinv[m1,m2]
    applied to context; fluctuation drawn with covsqrt =
    eigpow(inv(Cinv[m1,m1]), 1/2) (``pixcov.py:255-266``).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import Geometry, arcmin
from ..ops import fourier as F
from .grf import eig_pow

__all__ = [
    "ps2d_to_mat", "rotate_pol_power", "stamp_pixcov_from_theory",
    "scov_from_theory", "ncov_ivar_diag", "get_geometry_regions",
    "make_geometry", "make_geometries_batched", "inpaint_stamp",
    "inpaint_stamps_batched", "extract_stamps", "insert_stamps", "inpaint",
    "save_geometries", "load_geometries", "map_ifft", "resolution",
    "get_regions", "paste", "pcov_from_ivar", "tpcov_from_ivar",
    "cinv_inpaint", "preload_geometries",
    "corrfun_thumb", "corr_to_mat", "fcov_to_rcorr", "ncov_from_ivar",
]


def ps2d_to_mat(p2d, geom_stamp: Geometry):
    """2D power (stamp Fourier grid, physical units) -> (n^2, n^2)
    block-circulant pixel covariance (reference ``pixcov.py:33`` +
    the npix/area scaling of ``fcov_to_rcorr`` at ``pixcov.py:87``)."""
    n_y, n_x = geom_stamp.shape
    corr = jnp.fft.ifft2(p2d * (geom_stamp.npix / geom_stamp.area)).real
    iy = np.arange(n_y)
    ix = np.arange(n_x)
    dy = (iy[:, None] - iy[None, :]) % n_y        # (n, n)
    dx = (ix[:, None] - ix[None, :]) % n_x
    # mat[(i,j),(k,l)] = corr[(k-i)%n, (l-j)%n]
    mat = corr[dy.T[:, None, :, None], dx.T[None, :, None, :]]
    return mat.reshape(n_y * n_x, n_y * n_x)


def rotate_pol_power(geom: Geometry, cov, iau: bool = False,
                     inverse: bool = False):
    """Rotate (3,3,ny,nx) 2D power between TEB and TQU
    (reference ``pixcov.py:42``)."""
    prot = F.queb_rotmat(geom, inverse=inverse, iau=iau)
    rot = jnp.zeros((3, 3) + geom.shape).at[0, 0].set(1.0)
    rot = rot.at[1:, 1:].set(prot)
    return jnp.einsum("ab...,bc...,dc...->ad...", rot, cov, rot)


def stamp_pixcov_from_theory(geom_stamp: Geometry, cmb2d_TEB, n2d_IQU=0.0,
                             beam2d=1.0, iau: bool = False):
    """(ncomp, ncomp, n^2, n^2) stamp covariance from 2D TEB CMB power,
    beam and IQU noise power (reference ``pixcov.py:67``)."""
    cmb2d = jnp.asarray(cmb2d_TEB)
    ncomp = cmb2d.shape[0]
    if ncomp == 3:
        cmb2d = rotate_pol_power(geom_stamp, cmb2d, iau=iau, inverse=True)
    p2d = cmb2d * jnp.asarray(beam2d) ** 2 + n2d_IQU
    npx = geom_stamp.npix
    out = jnp.zeros((ncomp, ncomp, npx, npx))
    for i in range(ncomp):
        for j in range(i, ncomp):
            m = ps2d_to_mat(p2d[i, j], geom_stamp)
            out = out.at[i, j].set(m)
            if i != j:
                out = out.at[j, i].set(m)
    return out


def scov_from_theory(geom_stamp: Geometry, theory, beam_fn=None,
                     ncomp: int = 3, iau: bool = False):
    """Signal stamp covariance from a TheorySpectra + beam function
    (reference ``pixcov.py:117``), flattened to component-major
    (ncomp n^2, ncomp n^2)."""
    modlmap = geom_stamp.modlmap_np()
    ells = np.arange(theory.lpad + 1)

    def cl2d(spec):
        return jnp.asarray(np.interp(np.asarray(modlmap), ells,
                                     np.asarray(theory.lCl(spec, ells)),
                                     left=0, right=0))

    cmb = jnp.zeros((ncomp, ncomp) + geom_stamp.shape)
    cmb = cmb.at[0, 0].set(cl2d("TT"))
    if ncomp > 1:
        cmb = cmb.at[1, 1].set(cl2d("EE"))
        cmb = cmb.at[2, 2].set(cl2d("BB"))
        te = cl2d("TE")
        cmb = cmb.at[0, 1].set(te).at[1, 0].set(te)
    beam2d = beam_fn(modlmap) if beam_fn is not None else 1.0
    cov = stamp_pixcov_from_theory(geom_stamp, cmb, 0.0, beam2d, iau)
    return _comp_major(cov)


def _comp_major(cov4):
    """(ncomp,ncomp,npix,npix) -> (ncomp*npix, ncomp*npix), component-major
    blocks (the reference's transpose(0,2,1,3) ordering, pixcov.py:243)."""
    ncomp, _, npx, _ = cov4.shape
    return jnp.transpose(cov4, (0, 2, 1, 3)).reshape(ncomp * npx, ncomp * npx)


def ncov_ivar_diag(ivar_stamp, ncomp: int = 3):
    """Diagonal white-noise variance vector (comp-major, len ncomp*n^2)
    from an ivar stamp; QQ = UU = 2 II (reference ``pixcov.py:104``)."""
    iv = jnp.asarray(ivar_stamp).reshape(-1)
    maxvar = 1.0 / jnp.max(jnp.where(iv > 0, iv, -jnp.inf))
    var = jnp.where(iv > 0, 1.0 / jnp.where(iv > 0, iv, 1.0), maxvar)
    comps = [var] + [2.0 * var] * (ncomp - 1)
    return jnp.concatenate(comps[:ncomp])


def get_geometry_regions(ncomp: int, n: int, res: float, hole_radius: float):
    """Static hole (m1) and context (m2) index arrays, comp-major
    (reference ``pixcov.py:448``)."""
    y = (np.arange(n) - (n - 1) / 2.0) * res
    modrmap = np.sqrt(y[:, None] ** 2 + y[None, :] ** 2)
    a = np.tile(modrmap.reshape(-1), ncomp)
    m1 = np.where(a < hole_radius)[0]
    m2 = np.where(a >= hole_radius)[0]
    return m1, m2


@partial(jax.jit, static_argnames=("deproject", "ncomp"))
def make_geometry(pcov, m1, m2, deproject: bool = True, ncomp: int = 3):
    """covsqrt + meanmul from a (ncomp n^2, ncomp n^2) pixel covariance
    (reference ``pixcov.py:193``). Pure function — vmap over stamps.
    """
    N = pcov.shape[-1]
    npx = N // ncomp
    cinv = jnp.linalg.inv(pcov)
    if deproject:
        u = jnp.zeros((N, ncomp))
        for i in range(ncomp):
            u = u.at[i * npx:(i + 1) * npx, i].set(1.0)
        cinvu = jnp.linalg.solve(pcov, u)
        inner = jnp.linalg.solve(u.T @ cinvu, u.T)
        cinv = cinv - cinvu @ (inner @ cinv)
    c11 = cinv[jnp.ix_(m1, m1)]
    c12 = cinv[jnp.ix_(m1, m2)]
    meanmul = -jnp.linalg.solve(c11, c12)
    cov = jnp.linalg.inv(c11)
    covsqrt = eig_pow(cov, 0.5)
    return covsqrt, meanmul


def make_geometries_batched(scov, ivar_stamps, m1, m2, ncomp: int = 3,
                            deproject: bool = True):
    """Batched geometry precompute: one static signal covariance + per-stamp
    diagonal noise (the vmap replacement for the MPI-over-sources loop of
    reference ``pixcov.py:520``). Returns (B, nh, nh) covsqrt and
    (B, nh, nc) meanmul."""
    m1j = jnp.asarray(m1)
    m2j = jnp.asarray(m2)

    def one(ivar_stamp):
        nvar = ncov_ivar_diag(ivar_stamp, ncomp)
        pcov = scov + jnp.diag(nvar)
        return make_geometry(pcov, m1j, m2j, deproject=deproject, ncomp=ncomp)

    return jax.vmap(one)(jnp.asarray(ivar_stamps))


def inpaint_stamp(stamp, covsqrt, meanmul, m1, m2, key=None):
    """Max-like fill of the hole of one (ncomp, n, n) stamp (reference
    ``pixcov.py:296``). Comp-major flattening; key=None for mean-only."""
    flat = jnp.asarray(stamp).reshape(-1)
    mean = meanmul @ flat[m2]
    sim = mean
    if key is not None:
        r = jax.random.normal(key, (m1.shape[0],), flat.dtype)
        sim = mean + covsqrt @ r
    return flat.at[m1].set(sim).reshape(jnp.shape(stamp))


def inpaint_stamps_batched(stamps, covsqrts, meanmuls, m1, m2, keys=None):
    """vmap of :func:`inpaint_stamp` over (B, ncomp, n, n) stamps."""
    m1j, m2j = jnp.asarray(m1), jnp.asarray(m2)
    if keys is None:
        f = lambda s, c, m: inpaint_stamp(s, c, m, m1j, m2j, None)
        return jax.vmap(f)(stamps, covsqrts, meanmuls)
    f = lambda s, c, m, k: inpaint_stamp(s, c, m, m1j, m2j, k)
    return jax.vmap(f)(stamps, covsqrts, meanmuls, keys)


# ------------------------------------------------------------------
# big-map cutout plumbing
# ------------------------------------------------------------------

def extract_stamps(imap, pix_coords, n: int):
    """(B, ..., n, n) stamps centered at integer pixel coords (B, 2)
    (reference ``extract_cutouts``, ``pixcov.py:865``). Uses vmapped
    dynamic slices; coords must keep the stamp inside the map."""
    imap = jnp.asarray(imap)
    pix = jnp.asarray(pix_coords).astype(jnp.int32)
    start = pix - n // 2

    def one(s):
        zero = jnp.zeros((), s.dtype)
        starts = (zero,) * (imap.ndim - 2) + (s[0], s[1])
        sizes = imap.shape[:-2] + (n, n)
        return jax.lax.dynamic_slice(imap, starts, sizes)

    return jax.vmap(one)(start)


def insert_stamps(imap, stamps, pix_coords, n: int):
    """Write stamps back at their locations (sequential scan — stamps may
    overlap; last writer wins, as in the reference's in-place loop)."""
    imap = jnp.asarray(imap)
    pix = jnp.asarray(pix_coords).astype(jnp.int32)
    start = pix - n // 2

    def body(carry, xs):
        st, s = xs
        zero = jnp.zeros((), s.dtype)
        starts = (zero,) * (imap.ndim - 2) + (s[0], s[1])
        return jax.lax.dynamic_update_slice(carry, st, starts), 0

    out, _ = jax.lax.scan(body, imap, (jnp.asarray(stamps), start))
    return out


def inpaint(imap, coords_pix, geom: Geometry, theory, beam_fn,
            ivar=None, noise_uk_arcmin=None, hole_radius_arcmin=5.0,
            npix_context: int = 40, ncomp: int = None, key=None,
            deproject: bool = True):
    """End-to-end joint IQU inpainting of circular holes (reference
    ``pixcov.py:334``): build the stamp geometry from theory+beam+noise,
    batch-precompute, extract stamps, fill, re-insert.
    """
    imap = jnp.asarray(imap)
    if ncomp is None:
        ncomp = imap.shape[0] if imap.ndim == 3 else 1
    n = npix_context
    gstamp = Geometry(n, n, geom.dy, geom.dx)
    scov = scov_from_theory(gstamp, theory, beam_fn, ncomp=ncomp)
    # hole/context selection from the STAMP's own (possibly
    # anisotropic) physical distance map, so the partition and the
    # covariance agree for dy != dx geometries
    m1, m2 = get_regions(ncomp, gstamp.modrmap_np(),
                         hole_radius_arcmin * arcmin)
    coords_pix = np.asarray(coords_pix)
    # skip sources whose context stamp would overlap the map edge:
    # lax.dynamic_slice CLAMPS, so an edge stamp is mis-centered and
    # the infill would overwrite good pixels offset from the source
    # (the reference detects and skips these, pixcov.py:414-426)
    ny_m, nx_m = imap.shape[-2:]
    half = n // 2
    good = ((coords_pix[:, 0] >= half) & (coords_pix[:, 0] < ny_m - half)
            & (coords_pix[:, 1] >= half) & (coords_pix[:, 1] < nx_m - half))
    nskip = int((~good).sum())
    if nskip:
        import warnings
        warnings.warn(f"inpaint: skipping {nskip}/{len(good)} sources "
                      "whose context stamps overlap the map edge")
        coords_pix = coords_pix[good]
        if coords_pix.shape[0] == 0:
            return imap
    coords_pix = jnp.asarray(coords_pix)
    B = coords_pix.shape[0]
    if ivar is not None:
        ivar_stamps = extract_stamps(ivar, coords_pix, n)
    else:
        iv = 1.0 / ((noise_uk_arcmin * arcmin) ** 2 / geom.pixsize)
        ivar_stamps = jnp.full((B, n, n), iv)
    covsqrts, meanmuls = make_geometries_batched(scov, ivar_stamps, m1, m2,
                                                 ncomp=ncomp,
                                                 deproject=deproject)
    stamps = extract_stamps(imap if imap.ndim == 3 else imap[None],
                            coords_pix, n)
    keys = jax.random.split(key, B) if key is not None else None
    filled = inpaint_stamps_batched(stamps, covsqrts, meanmuls, m1, m2, keys)
    out = insert_stamps(imap if imap.ndim == 3 else imap[None],
                        filled, coords_pix, n)
    return out if imap.ndim == 3 else out[0]


def save_geometries(fname, covsqrts, meanmuls, m1, m2, meta=None):
    """Persist batched inpainting geometries (reference saves per-source
    HDF5, ``pixcov.py:677``; one npz here)."""
    np.savez(fname, covsqrts=np.asarray(covsqrts),
             meanmuls=np.asarray(meanmuls), m1=np.asarray(m1),
             m2=np.asarray(m2), **(meta or {}))


def load_geometries(fname):
    d = np.load(fname)
    return (jnp.asarray(d["covsqrts"]), jnp.asarray(d["meanmuls"]),
            d["m1"], d["m2"])


# ---------------------------------------------------------------------------
# Reference-surface tail (pixcov.py:19, 104, 208, 239, 303, 361, 520, 586)
# ---------------------------------------------------------------------------

def map_ifft(x, geom: Geometry = None):
    """Real part of the inverse FFT (reference ``pixcov.py:19``)."""
    return jnp.fft.ifft2(jnp.asarray(x)).real


def corrfun_thumb(corr, n_y, n_x=None):
    """Cut the (2 n_y, 2 n_x) separation thumbnail out of a full-map
    correlation function (reference ``pixcov.py:21``): cyclic shifts
    place separations ``[-n, n)`` contiguously before cropping, then
    shift back so index 0 is zero separation again."""
    if n_x is None:
        n_x = n_y
    corr = jnp.asarray(corr)
    tmp = jnp.roll(jnp.roll(corr, n_x, -1)[..., :2 * n_x],
                   n_y, -2)[..., :2 * n_y, :]
    return jnp.roll(jnp.roll(tmp, -n_x, -1), -n_y, -2)


def corr_to_mat(corr, n_y, n_x=None):
    """(n_y*n_x per side) pixel-pixel matrix from a cyclic correlation
    thumbnail: ``mat[i,j,k,l] = corr[(k-i) % H, (l-j) % W]`` (reference
    ``pixcov.py:25`` — the double roll loop, done as one gather)."""
    if n_x is None:
        n_x = n_y
    corr = jnp.asarray(corr)
    h, w = corr.shape[-2:]
    iy = np.arange(n_y)
    ix = np.arange(n_x)
    dy = (iy[None, :] - iy[:, None]) % h          # (i, k)
    dx = (ix[None, :] - ix[:, None]) % w          # (j, l)
    return corr[..., dy[:, None, :, None], dx[None, :, None, :]]


def fcov_to_rcorr(geom: Geometry, p2d, n_y, n_x=None):
    """(ncomp, ncomp, Ny, Nx) 2D power -> (ncomp, ncomp, n_y*n_x,
    n_y*n_x) pixel covariance for an ``n_y x n_x`` thumbnail (reference
    ``pixcov.py:87``): npix/area physical scaling, correlation via the
    inverse FFT, cyclic thumbnail, separation gather. ``geom`` is the
    geometry the power grid lives on (its shape must match p2d)."""
    if n_x is None:
        n_x = n_y
    p2d = jnp.asarray(p2d)
    if p2d.ndim == 2:
        p2d = p2d[None, None]
    ncomp = p2d.shape[0]
    corr = jnp.fft.ifft2(p2d * (geom.npix / geom.area)).real
    thumb = corrfun_thumb(corr, n_y, n_x)
    mat = corr_to_mat(thumb, n_y, n_x)            # (nc, nc, ny, nx, ny, nx)
    return mat.reshape(ncomp, ncomp, n_y * n_x, n_y * n_x)


def ncov_from_ivar(ivar, ncomp: int = 3):
    """Dense diagonal IQU noise covariance from an inverse-variance map
    (reference ``pixcov.py:104``): var = 1/ivar, with zero-ivar pixels
    assigned ``1/max(ivar)`` — the variance of the *best*-measured
    pixel, i.e. the reference's regularization (its stated aim is only
    to avoid singular matrices; unobserved pixels end up maximally
    trusted, so mask them upstream if that matters). QQ = UU = 2 II.
    Returns
    (ncomp, ncomp, N, N) with N = ny*nx. The diagonal-vector form used
    by the batched inpainting path is ``ncov_ivar_diag``."""
    ivar = jnp.asarray(ivar)
    if ivar.ndim != 2:
        raise ValueError("ivar must be a 2D map")
    iv = ivar.reshape(-1)
    maxvar = 1.0 / jnp.max(jnp.where(iv > 0, iv, -jnp.inf))
    var = jnp.where(iv > 0, 1.0 / jnp.where(iv > 0, iv, 1.0), maxvar)
    n = var.shape[0]
    out = jnp.zeros((ncomp, ncomp, n, n), var.dtype)
    for c in range(ncomp):
        fac = 1.0 if c == 0 else 2.0
        out = out.at[c, c].set(jnp.diag(fac * var))
    return out


def resolution(geom: Geometry):
    """Pixel size in radians (reference ``pixcov.py:104`` applies
    abs(): CAR-style negative dy must not flip the sign)."""
    return float(min(abs(geom.dy), abs(geom.dx)))


def get_regions(ncomp: int, modrmap, hole_radius):
    """Hole (m1) / context (m2) flat indices across components from a
    distance map (reference ``pixcov.py:520``). Like
    ``get_geometry_regions`` but for an arbitrary (possibly offset)
    modrmap."""
    modrmap = np.asarray(modrmap)
    if modrmap.ndim != 2:
        raise ValueError("modrmap must be 2D")
    rep = np.repeat(modrmap[None], ncomp, 0).reshape(-1)
    m1 = np.where(rep < hole_radius)[0]
    m2 = np.where(rep >= hole_radius)[0]
    return m1, m2


def paste(stamp, m, paste_this):
    """Write values into the flat indices ``m`` of a stamp (reference
    ``pixcov.py:303``), returning the updated stamp."""
    stamp = jnp.asarray(stamp)
    flat = stamp.reshape(-1).at[jnp.asarray(m)].set(
        jnp.asarray(paste_this, stamp.dtype))
    return flat.reshape(stamp.shape)


def pcov_from_ivar(n, ivar_stamp, theory_fn, beam_fn, geom_stamp: Geometry,
                   iau=False):
    """(3, 3, n^2, n^2) IQU pixel covariance from an inverse-variance
    stamp + theory/beam functions (reference ``pixcov.py:239``):
    signal pixcov from theory plus a diagonal noise cov with the pol
    variance doubled."""
    ivar = np.asarray(ivar_stamp)
    with np.errstate(divide="ignore"):
        var = 1.0 / ivar
    var[~np.isfinite(var)] = 1.0 / ivar[ivar > 0].max()
    modlmap = geom_stamp.modlmap_np()
    cmb2d = np.zeros((3, 3, n, n))
    for i, s in enumerate(("TT", "EE", "BB")):
        cmb2d[i, i] = theory_fn(s, modlmap)
    cmb2d[0, 1] = cmb2d[1, 0] = theory_fn("TE", modlmap)
    scov = stamp_pixcov_from_theory(geom_stamp, jnp.asarray(cmb2d),
                                    n2d_IQU=0.0,
                                    beam2d=jnp.asarray(beam_fn(modlmap)),
                                    iau=iau)
    ncov = np.zeros((3, 3, n * n, n * n))
    d = np.diag(var.reshape(-1))
    ncov[0, 0] = d
    ncov[1, 1] = d * 2.0
    ncov[2, 2] = d * 2.0
    return jnp.asarray(scov) + jnp.asarray(ncov)


def tpcov_from_ivar(n, ivar_stamp, theory_fn, beam_fn,
                    geom_stamp: Geometry):
    """Temperature-only (1, 1, n^2, n^2) pixel covariance from ivar +
    theory/beam (reference ``pixcov.py:208``)."""
    ivar = np.asarray(ivar_stamp)
    with np.errstate(divide="ignore"):
        var = 1.0 / ivar
    var[~np.isfinite(var)] = 1.0 / ivar[ivar > 0].max()
    modlmap = geom_stamp.modlmap_np()
    cmb2d = np.zeros((1, 1, n, n))
    cmb2d[0, 0] = theory_fn("TT", modlmap)
    tcov = stamp_pixcov_from_theory(geom_stamp, jnp.asarray(cmb2d),
                                    n2d_IQU=0.0,
                                    beam2d=jnp.asarray(beam_fn(modlmap)))
    ncov = np.diag(var.reshape(-1))[None, None]
    return jnp.asarray(tcov) + jnp.asarray(ncov)


def cinv_inpaint(imap, geom: Geometry, mask=None, lpower_total=None,
                 geometry=None, key=None, add_noise=True):
    """Inpaint a small map by constrained Gaussian fill (reference
    ``pixcov.py:361``): either pass a precomputed ``geometry`` dict
    (covsqrt/meanmul/m1/m2) or a boolean hole ``mask`` + total 1D power
    ``lpower_total`` from which the geometry is built."""
    imap = jnp.asarray(imap)
    if geometry is None:
        if mask is None or lpower_total is None:
            raise ValueError("need geometry, or mask + lpower_total")
        mask = np.asarray(mask, bool).reshape(-1)
        m1 = np.where(mask)[0]
        m2 = np.where(~mask)[0]
        p2d = np.interp(geom.modlmap_np(),
                        np.arange(len(lpower_total)), lpower_total)
        pcov = ps2d_to_mat(jnp.asarray(p2d), geom)
        covsqrt, meanmul = make_geometry(pcov, jnp.asarray(m1),
                                         jnp.asarray(m2), ncomp=1)
        geometry = dict(covsqrt=covsqrt, meanmul=meanmul, m1=m1, m2=m2)
    return inpaint_stamp(imap, geometry["covsqrt"], geometry["meanmul"],
                         jnp.asarray(geometry["m1"]),
                         jnp.asarray(geometry["m2"]),
                         key=key if add_noise else None)


def preload_geometries(fnames):
    """Load many saved inpainting geometries into one dict keyed by
    index (reference ``pixcov.py:586``)."""
    return {i: load_geometries(f) for i, f in enumerate(fnames)}
