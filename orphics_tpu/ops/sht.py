"""Native spherical-harmonic transforms on iso-latitude rings.

Replaces the reference's use of ``pixell.curvedsky`` / ``healpy.sphtfunc``
(reference ``orphics/maps.py:2`` import, ``:744`` ``cs.rand_map``,
``:973-974`` alm filtering in ``stitched_noise``, ``:1009`` ``cs.alm2cl``,
``:1133`` alm-space coadds) with an original JAX implementation designed
for XLA:

* The sphere is sampled on **iso-latitude rings** (Gauss-Legendre nodes or
  an equiangular Clenshaw-Curtis grid, both with *exact* quadrature for
  band-limited fields). Maps are dense ``(..., ntheta, nphi)`` arrays.
* The longitude direction is handled by batched real/complex FFTs (XLA).
* The latitude direction uses normalized Wigner-d functions
  ``Lambda_l^{m,n}(theta) = sqrt((2l+1)/4pi) d^l_{mn}(theta)`` generated
  by a single ``lax.scan`` over ``l`` with all ``m`` (and all rings)
  vectorized — compiler-friendly static shapes, no data-dependent control
  flow. Spin-0 is the ``n = 0`` column; spin-s uses the ``n = -s, +s``
  pair combined into the classic ``(W, X)`` kernels.
* Underflow of the high-m seeds (the classic SHT failure mode in fp32) is
  handled with an extended-exponent representation: each ``(m, ring)``
  lane carries an integer count of ``2^-30`` suppressions that is unwound
  as the recursion climbs out of the classically-forbidden region.
* The l-scan advances ``_LBLOCK`` l's per step (recurrence unrolled in
  the body) and contracts per *block*, so the (m, rings) contractions are
  batched matrix products with K = ``_LBLOCK`` rather than per-l vector
  ops. They run at ``_EPREC`` precision (see there).

fp32 accuracy: the recurrence runs in the ``_COMPENSATE`` mode "full"
(split-float tables, a TwoSum lo channel and Dekker TwoProd on the
recurrence products, see ``_lambda_scan``), which removes the recurrence
as an error source: the plain-fp32 recurrence's error was the
l^2-amplified product rounding at the m <= 8 columns, not polar-ring
amplitude. The roundtrip error left is that of the fp32 contractions and
ring FFTs; PERF.md records it as measured on the GPU. The O(lmax^2)
recurrence tables enter the compiled program as device *arguments*, not
constants (``_scan_tables_host``), so programs stay small at lmax 4096+
and tables transfer once per (rings, lmax, dtype) working set. For
reference-parity float64 precision run under ``jax_enable_x64`` (the CPU
test configuration, which round-trips to ~1e-12).

Conventions match healpy: Condon-Shortley phase, alm packed in m-major
triangular order (``ops/alm.py``), and the CMB polarization convention
``a_{±2,lm} = -(E_lm ± i B_lm)``.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from . import alm as almops

__all__ = [
    "RingGeom",
    "gauss_legendre_rings",
    "clenshaw_curtis_rings",
    "map2alm",
    "alm2map",
    "map2alm_spin",
    "alm2map_spin",
    "map2alm_pol",
    "alm2map_pol",
]

# Extended-exponent parameters: true value = mantissa * 2**(-30 * e).
_RESCALE_BITS = 30
_RESCALE = float(2.0 ** _RESCALE_BITS)
_INV_RESCALE = float(2.0 ** -_RESCALE_BITS)
_RESCALE_THRESH = float(2.0 ** (_RESCALE_BITS // 2))

# Contraction precision of the (m, rings) einsums. On a GPU a batch of
# maps makes them cuBLAS GEMMs, where HIGH and DEFAULT mean TF32 (10-bit
# mantissa inputs) and HIGHEST keeps full fp32 inputs; one map's
# matrix-vector product is fused in fp32 at any precision. The lmax-2047
# roundtrip error of each, measured on an H100, is in PERF.md.
_EPREC = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Ring geometries
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RingGeom:
    """Iso-latitude ring sampling of the full sphere.

    Attributes
    ----------
    theta : tuple of float
        Colatitudes of the rings (radians, ascending from the north pole).
    weights : tuple of float
        Quadrature weights including the ``sin(theta) dtheta`` measure:
        ``sum_j w_j f(theta_j) ~= int_0^pi f(theta) sin(theta) dtheta``
        exactly for the band-limit the constructor was built for.
    nphi : int
        Number of equispaced samples per ring (same for all rings).
    phi0 : float
        Longitude of the first sample of each ring.
    """

    theta: tuple
    weights: tuple
    nphi: int
    phi0: float = 0.0

    @property
    def ntheta(self) -> int:
        return len(self.theta)

    @property
    def shape(self):
        return (self.ntheta, self.nphi)

    def theta_array(self):
        return np.asarray(self.theta, np.float64)

    def weights_array(self):
        return np.asarray(self.weights, np.float64)


def _fast_fft_len(n: int) -> int:
    """Smallest 5-smooth integer >= n (friendly FFT length)."""
    m = n
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


@lru_cache(maxsize=16)
def gauss_legendre_rings(lmax: int, nphi: int = None, phi0: float = 0.0):
    """Gauss-Legendre ring grid: exact analysis quadrature for band limit
    ``lmax`` with the minimal ``lmax + 1`` rings."""
    ntheta = lmax + 1
    try:
        from scipy.special import roots_legendre
        x, w = roots_legendre(ntheta)
    except ImportError:
        x, w = np.polynomial.legendre.leggauss(ntheta)
    # x ascending in cos(theta) => theta descending; reorder north->south.
    theta = np.arccos(x)[::-1]
    w = w[::-1]
    if nphi is None:
        nphi = _fast_fft_len(2 * lmax + 1)
    return RingGeom(tuple(theta), tuple(w), int(nphi), float(phi0))


@lru_cache(maxsize=16)
def clenshaw_curtis_rings(ntheta: int, nphi: int = None, phi0: float = 0.0):
    """Equiangular (CAR-like) grid with poles included:
    ``theta_j = j pi / (ntheta - 1)``.

    The weights solve the cosine moment conditions
    ``sum_j w_j cos(k theta_j) = int_0^pi cos(k theta) sin(theta) dtheta``
    for ``k = 0 .. ntheta-1`` (computed with a DCT-I), so analysis is exact
    for band limits ``2*lmax + 1 <= ntheta``.
    """
    if ntheta < 2:
        raise ValueError("need at least 2 rings")
    M = ntheta - 1
    theta = np.arange(ntheta) * (np.pi / M)
    k = np.arange(ntheta)
    # I_k = int_0^pi cos(k t) sin(t) dt = (1 + cos(pi k)) / (1 - k^2)
    with np.errstate(divide="ignore", invalid="ignore"):
        I = (1.0 + np.cos(np.pi * k)) / (1.0 - k.astype(np.float64) ** 2)
    I[1] = 0.0
    # Solve C w = I with C_{kj} = cos(pi k j / M) via DCT-I orthogonality:
    # w_j = (2/M) * c_j * sum_k'' I_k cos(pi k j / M), c_{0,M} = 1/2.
    ext = np.concatenate([I, I[-2:0:-1]])          # even extension, len 2M
    dct = np.fft.rfft(ext).real                     # DCT-I up to scaling
    w = dct / M
    w[0] *= 0.5
    w[-1] *= 0.5
    # Verify the moment conditions (cheap, catches any scaling slip).
    chk = np.cos(np.outer(k[: min(8, ntheta)], theta)) @ w
    ref = I[: min(8, ntheta)]
    if not np.allclose(chk, ref, atol=1e-10):
        raise AssertionError("CC quadrature weights failed moment check")
    if nphi is None:
        nphi = _fast_fft_len(2 * ntheta - 1)
    return RingGeom(tuple(theta), tuple(w), int(nphi), float(phi0))


# ---------------------------------------------------------------------------
# Wigner-d seeds and recurrence coefficients (host, float64)
# ---------------------------------------------------------------------------

def _seed_log_coeff(m: np.ndarray, n: int):
    """Per-m seed of the l-recursion at ``l0 = max(m, |n|)``.

    At ``l = max(|m|, |n|)`` the Wigner sum formula collapses to a single
    term ``k0``:
        d^{l0}_{mn}(t) = s * exp(logC) * cos(t/2)^pc * sin(t/2)^ps
    Returns (sign, logC, pc, ps, l0) arrays over m.
    """
    from scipy.special import gammaln

    m = np.asarray(m, np.int64)
    l0 = np.maximum(m, abs(n))
    k0 = np.maximum(0, n - m)
    lf = lambda v: gammaln(np.asarray(v, np.float64) + 1.0)
    logC = 0.5 * (lf(l0 + m) + lf(l0 - m) + lf(l0 + n) + lf(l0 - n)) \
        - lf(l0 + n - k0) - lf(k0) - lf(m - n + k0) - lf(l0 - m - k0)
    sign = np.where((m - n + k0) % 2 == 0, 1.0, -1.0)
    pc = 2 * l0 + n - m - 2 * k0
    ps = m - n + 2 * k0
    # Normalization sqrt((2 l0 + 1) / 4 pi)
    logC = logC + 0.5 * np.log((2 * l0 + 1) / (4.0 * np.pi))
    return sign, logC, pc.astype(np.int64), ps.astype(np.int64), l0


def _recur_coeffs(l: np.ndarray, m: np.ndarray, n: int):
    """Coefficients of  Lambda_l = (A x + B) Lambda_{l-1} + C Lambda_{l-2}.

    Three-term recurrence in l for the normalized Wigner d
    (Varshalovich 4.8.28 shifted to advance to l):

      d^l = { (2l-1)[(l-1) l x - m n] d^{l-1} - l u_{l-1} d^{l-2} }
            / ( (l-1) u_l ),   u_l = sqrt((l^2-m^2)(l^2-n^2))

    valid for l >= l0+1 with d^{l0-1} := 0 (the d^{l-2} coefficient
    vanishes there because u_{l0} = 0), EXCEPT the single cell
    (l=1, m=0, n=0) where the (l-1) denominator is singular and the true
    relation is Lambda_1 = sqrt(3) x Lambda_0. Includes the
    sqrt((2l+1)/4pi) normalization ratios.
    """
    l = np.asarray(l, np.float64)[:, None]
    m = np.asarray(m, np.float64)[None, :]
    nn = float(n)
    with np.errstate(divide="ignore", invalid="ignore"):
        u_l = np.sqrt((l * l - m * m) * (l * l - nn * nn))
        u_lm1 = np.sqrt(((l - 1) ** 2 - m * m) * ((l - 1) ** 2 - nn * nn))
        denom = (l - 1) * u_l
        A = (2 * l - 1) * (l - 1) * l / denom
        B = -(2 * l - 1) * m * nn / denom
        C = -l * u_lm1 / denom
        r1 = np.sqrt((2 * l + 1) / (2 * l - 1))
        r2 = np.sqrt((2 * l + 1) / np.maximum(2 * l - 3, 1e-300))
        A = A * r1
        B = B * r1
        C = C * r2
        # singular cell (l=1, m=0) for n=0: Lambda_1^{00} = sqrt(3) x Lambda_0
        if n == 0:
            sing = (l == 1) & (m == 0)
            A = np.where(sing, np.sqrt(3.0), A)
            B = np.where(sing, 0.0, B)
            C = np.where(sing, 0.0, C)
        # l <= l0: inactive (seed injection handles l == l0)
        l0 = np.maximum(np.abs(m), abs(nn))
        inactive = (l <= l0)
        A = np.where(inactive, 0.0, A)
        B = np.where(inactive, 0.0, B)
        C = np.where(inactive, 0.0, C)
    A = np.nan_to_num(A, nan=0.0, posinf=0.0, neginf=0.0)
    B = np.nan_to_num(B, nan=0.0, posinf=0.0, neginf=0.0)
    C = np.nan_to_num(C, nan=0.0, posinf=0.0, neginf=0.0)
    return A, B, C


@lru_cache(maxsize=32)
def _wigner_tables_np(lmax: int, ns: tuple):
    """Host-precomputed recurrence tables for the n-values in ``ns``.

    Returns dict of numpy arrays:
      A, B, C : (len(ns), lmax+1, mmax+1) recurrence coefficients
      seed_sign, seed_logC : (len(ns), mmax+1)
      seed_pc, seed_ps     : (len(ns), mmax+1) integer powers
      l0                   : (len(ns), mmax+1)
    """
    m = np.arange(lmax + 1)
    ls = np.arange(lmax + 1)
    A = []; B = []; C = []; sg = []; lc = []; pc = []; ps = []; l0s = []
    for n in ns:
        a, b, c = _recur_coeffs(ls, m, n)
        s, logc, p_c, p_s, l0 = _seed_log_coeff(m, n)
        A.append(a); B.append(b); C.append(c)
        sg.append(s); lc.append(logc); pc.append(p_c); ps.append(p_s)
        l0s.append(l0)
    return dict(
        A=np.stack(A), B=np.stack(B), C=np.stack(C),
        seed_sign=np.stack(sg), seed_logC=np.stack(lc),
        seed_pc=np.stack(pc), seed_ps=np.stack(ps),
        l0=np.stack(l0s),
    )


_DD_SPLIT = 2.0 ** 12 + 1.0      # Dekker split constant for fp32


def _dd_twosum(a, b):
    """fl(a+b) and its exact fp32 rounding error (Knuth TwoSum).
    """
    s = a + b
    z = s - a
    return s, (a - (s - z)) + (b - z)


def _dd_twoprod(a, b):
    """fl(a*b) and its exact fp32 rounding error (Dekker TwoProd;
    valid for the bounded magnitudes the rescaled recurrence
    guarantees)."""
    p = a * b
    t = _DD_SPLIT * a
    ah = t - (t - a)
    al = a - ah
    t = _DD_SPLIT * b
    bh = t - (t - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _seed_mantissa_exp(tab, theta, dtype):
    """Seed values at l = l0(m) for every (n, m, ring), in extended-exponent
    form: value = mant * 2**(-30 e)."""
    ct2 = np.log(np.maximum(np.abs(np.cos(theta / 2.0)), 1e-300))
    st2 = np.log(np.maximum(np.abs(np.sin(theta / 2.0)), 1e-300))
    # log|seed| (n, m, rings)
    logv = (tab["seed_logC"][:, :, None]
            + tab["seed_pc"][:, :, None] * ct2[None, None, :]
            + tab["seed_ps"][:, :, None] * st2[None, None, :])
    log2v = logv / math.log(2.0)
    e = np.maximum(0, np.ceil((-log2v - 8.0) / _RESCALE_BITS)).astype(np.int32)
    mant = tab["seed_sign"][:, :, None] * np.exp(
        logv + e * (_RESCALE_BITS * math.log(2.0)))
    return mant.astype(dtype), e


def _seed_mantissa_exp_traced(tab, theta, dtype):
    """Traced-theta version of :func:`_seed_mantissa_exp` (jnp ops), for
    ring-distributed transforms where each shard's colatitudes are a
    device-local traced array. The log/exp evaluation in the working
    dtype costs ~|log seed| * eps relative seed error (negligible under
    x64; ~1e-4-class under fp32, at the existing fp32 recurrence
    floor)."""
    theta = jnp.asarray(theta, jnp.result_type(dtype, jnp.float32))
    ct2 = jnp.log(jnp.maximum(jnp.abs(jnp.cos(theta / 2.0)), 1e-300))
    st2 = jnp.log(jnp.maximum(jnp.abs(jnp.sin(theta / 2.0)), 1e-300))
    logv = (jnp.asarray(tab["seed_logC"], theta.dtype)[:, :, None]
            + jnp.asarray(tab["seed_pc"], theta.dtype)[:, :, None]
            * ct2[None, None, :]
            + jnp.asarray(tab["seed_ps"], theta.dtype)[:, :, None]
            * st2[None, None, :])
    log2v = logv / math.log(2.0)
    e = jnp.maximum(0, jnp.ceil((-log2v - 8.0) / _RESCALE_BITS)
                    ).astype(jnp.int32)
    mant = (jnp.asarray(tab["seed_sign"], theta.dtype)[:, :, None]
            * jnp.exp(logv + e * (_RESCALE_BITS * math.log(2.0))))
    return mant.astype(dtype), e


# ---------------------------------------------------------------------------
# Core scan: generalized Legendre/Wigner transform over l
# ---------------------------------------------------------------------------

_LBLOCK = 16  # l's advanced per scan step (unrolled in the body)
# fp32 recurrence compensation: False/"off" = plain fp32,
# True/"lite" = dd-lite (split tables + TwoSum + first-order lo
# channel), "full" = dd-lite plus Dekker TwoProd on the recurrence
# products (kills the polar low-m amplification; see _lambda_scan).
_COMPENSATE = "full"


def _comp_mode():
    c = _COMPENSATE
    if c is True:
        return "lite"
    if c is False or c is None:
        return "off"
    return c


def _pad_l_axis(arr, L1, Lpad, axis):
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, Lpad - L1)
    return np.pad(np.asarray(arr), pad)


@lru_cache(maxsize=4)
def _scan_tables_host(lmax, ns, dtype_str, theta, mode, block):
    """Every static per-(lmax, rings) input of the l-scan, as HOST numpy
    arrays (cached).

    The public transforms feed these to their jitted implementations as
    *device arguments* rather than letting them bake in as program
    constants: the recurrence tables are O(lmax^2) (an lmax-4096 fp32
    set is ~0.5 GB), and embedding them blows up compile payloads and
    executable caches, while as arguments they transfer once and are
    reused.
    """
    dtype = np.dtype(dtype_str)
    nn = len(ns)
    tab = _wigner_tables_np(lmax, tuple(ns))
    L1 = lmax + 1
    nb = -(-L1 // block)
    Lpad = nb * block
    comp = mode != "off"
    theta_np = np.asarray(theta, np.float64)

    def _blk(name):
        return np.moveaxis(_pad_l_axis(tab[name], L1, Lpad, 1), 1, 0) \
            .reshape(nb, block, nn, L1)

    A64, B64, C64 = _blk("A"), _blk("B"), _blk("C")
    x64 = np.cos(theta_np)
    mant_np, e_np = _seed_mantissa_exp(tab, theta_np, np.float64)
    out = {
        "A": A64.astype(dtype), "B": B64.astype(dtype),
        "C": C64.astype(dtype),
        "x": x64.astype(dtype),
        "seed_m": mant_np.astype(dtype), "seed_e": e_np.astype(np.int32),
        "l0": np.asarray(tab["l0"]),
    }
    if comp:
        out["Al"] = (A64 - A64.astype(np.float32)).astype(dtype)
        out["Bl"] = (B64 - B64.astype(np.float32)).astype(dtype)
        out["Cl"] = (C64 - C64.astype(np.float32)).astype(dtype)
        out["xlo"] = (x64 - x64.astype(np.float32)).astype(dtype)
        out["seed_lo"] = (mant_np - mant_np.astype(np.float32)).astype(dtype)
    else:
        out["Al"] = out["Bl"] = out["Cl"] = \
            np.zeros((nb, block, 0, L1), dtype)
        out["xlo"] = np.zeros((0,), dtype)
        out["seed_lo"] = np.zeros((nn, 0, 0), dtype)
    return out


def _tracing_active() -> bool:
    """True when called under an active jax trace (outer jit / scan /
    shard_map) — jnp.asarray then returns tracers that must never be
    cached. jax.core.trace_state_clean was removed in jax 0.9; probe
    the private location with a conservative fallback."""
    try:
        from jax._src import core as _core
        return not _core.trace_state_clean()
    except Exception:
        x = jnp.zeros((), jnp.float32)
        return "Tracer" in type(x).__name__


@lru_cache(maxsize=4)
def _scan_tables_dev_cached(lmax, ns, dtype_str, theta, mode, block):
    host = _scan_tables_host(lmax, ns, dtype_str, theta, mode, block)
    return {k: jnp.asarray(v) for k, v in host.items()}


def _scan_tables_dev(lmax, ns, dtype_str, theta, mode, block=_LBLOCK):
    """Device-resident copy of :func:`_scan_tables_host` (cached so the
    transfer happens once per (lmax, rings, dtype, mode) working set).

    Inside an active trace (a transform called under an outer jit /
    scan / shard_map), ``jnp.asarray`` yields TRACERS — caching those
    would leak them into later traces (UnexpectedTracerError). There
    the host cache still hits, but the device conversion is redone per
    trace as in-program constants (the documented degraded mode)."""
    if _tracing_active():
        host = _scan_tables_host(lmax, ns, dtype_str, theta, mode,
                                 block)
        return {k: jnp.asarray(v) for k, v in host.items()}
    return _scan_tables_dev_cached(lmax, ns, dtype_str, theta, mode,
                                   block)


def _mode_for(dtype, traced=False):
    return _comp_mode() if (jnp.dtype(dtype) == jnp.float32
                            and not traced) else "off"


def _lambda_scan(lmax, theta_np, ns, dtype, contract, init_out, xs=None,
                 block: int = _LBLOCK, vary_axes: tuple = (),
                 tables=None):
    """Run the l-recursion for the Wigner columns ``ns`` in l-blocks.

    The recurrence is sequential in l, but the *contraction* need not be
    evaluated one l at a time: the scan advances ``block`` l's per step
    (recurrence unrolled in the body, O(block) VPU work), stacks the
    rescaled ``Lambda`` planes, and calls ``contract(l_base, lam_blk,
    out, x_blk)`` ONCE per block with ``lam_blk`` of shape
    ``(block, len(ns), mmax+1, nrings)``. That turns the per-l
    (m, rings) elementwise-sum contractions into K = ``block`` matmuls
    (batched matrix products) and cuts scan-iteration overhead by
    ``block``x.

    ``contract`` must return the updated ``out`` carry; ``xs`` is an
    optional per-l scanned input (leading axis lmax+1, e.g. alm rows for
    synthesis), delivered to ``contract`` as blocks of ``block`` rows
    (zero-padded past lmax). l's beyond lmax have zero recurrence
    coefficients, so their lam rows are exactly zero.
    """
    nn = len(ns)
    L1 = lmax + 1
    nb = -(-L1 // block)
    Lpad = nb * block
    traced = isinstance(theta_np, jnp.ndarray)
    # Compensated fp32 modes. The fp32 recurrence error has three
    # coherent sources: (1) the rounding of x = cos(theta) and of the
    # A/B/C tables — fixed by carrying their float64 residuals as
    # split-float corrections; (2) the per-step fp32 *addition*
    # rounding — fixed by a second "lo" channel for Lambda (TwoSum on
    # the main addition, first-order propagation of lo through the
    # recurrence); (3) the per-step *product* rounding of p*lam_c and
    # c*lam_p, which the lo channel cannot see and which is l^2-
    # amplified on near-polar rings for the m <= 8 columns (the modes
    # whose Lambda is not sin^m-suppressed at the poles; measured up to
    # ~1e-3 relative at lmax 2048). Mode "lite" fixes (1)+(2); mode
    # "full" (default) also fixes (3) with Dekker TwoProd error terms
    # (exact fp32 product splitting — no FMA needed), which collapses
    # the worst-ring recurrence error to <2e-9 in a step-exact host
    # emulation and lands the on-chip roundtrip at ~10 ulp (see module
    # header). Traced-theta (distributed) paths have no float64 host
    # value to split, so they stay plain fp32.
    mode = _mode_for(dtype, traced)
    comp = mode != "off"
    full = mode == "full"
    if traced:
        tab = _wigner_tables_np(lmax, tuple(ns))
        x = jnp.cos(jnp.asarray(theta_np, dtype))  # (T,)
        xlo = None

        def _blk(name):
            return np.moveaxis(_pad_l_axis(tab[name], L1, Lpad, 1), 1, 0) \
                .reshape(nb, block, nn, L1)

        # per-block scanned tables: (nb, block, nn, M+1)
        A = jnp.asarray(_blk("A"), dtype)
        B = jnp.asarray(_blk("B"), dtype)
        C = jnp.asarray(_blk("C"), dtype)
        Al = Bl = Cl = jnp.zeros((nb, block, 0, L1), dtype)
        seed_m, seed_e = _seed_mantissa_exp_traced(tab, theta_np, dtype)
        seed_lo = None
        l0 = jnp.asarray(tab["l0"])           # (nn, M+1)
    else:
        if tables is None:
            theta_key = tuple(np.asarray(theta_np, np.float64).tolist())
            tables = _scan_tables_host(lmax, tuple(ns), np.dtype(dtype).str,
                                       theta_key, mode, block)
        x = jnp.asarray(tables["x"])
        xlo = jnp.asarray(tables["xlo"]) if comp else None
        A = jnp.asarray(tables["A"])
        B = jnp.asarray(tables["B"])
        C = jnp.asarray(tables["C"])
        Al = jnp.asarray(tables["Al"])
        Bl = jnp.asarray(tables["Bl"])
        Cl = jnp.asarray(tables["Cl"])
        seed_m = jnp.asarray(tables["seed_m"])   # (nn, M+1, T)
        seed_e = jnp.asarray(tables["seed_e"])   # (nn, M+1, T) int32
        seed_lo = jnp.asarray(tables["seed_lo"]) if comp else None
        l0 = jnp.asarray(tables["l0"])           # (nn, M+1)

    T = theta_np.shape[0]
    M1 = lmax + 1
    lam_p = jnp.zeros((nn, M1, T), dtype)
    lam_c = jnp.zeros((nn, M1, T), dtype)
    lam_pl = jnp.zeros((nn, M1, T), dtype)    # lo channels (dd-lite)
    lam_cl = jnp.zeros((nn, M1, T), dtype)
    e = jnp.zeros((nn, M1, T), jnp.int32)

    inv_r = jnp.asarray(_INV_RESCALE, dtype)
    thresh = jnp.asarray(_RESCALE_THRESH, dtype)

    # python-float split constant stays fp32 under jnp weak typing;
    # comp modes only run on fp32
    _twosum, _twoprod = _dd_twosum, _dd_twoprod

    def step(carry, scanned):
        Ab, Bb, Cb, Alb, Blb, Clb, lsb, xb = scanned
        lam_p, lam_c, lam_pl, lam_cl, e, out = carry
        lams = []
        for j in range(block):
            l = lsb[j]
            a = Ab[j][:, :, None]
            b = Bb[j][:, :, None]
            c = Cb[j][:, :, None]
            if comp:
                al = Alb[j][:, :, None]
                bl = Blb[j][:, :, None]
                cl = Clb[j][:, :, None]
                xb_ = x[None, None, :]
                pe0 = a * xlo[None, None, :] + al * xb_ + bl
                if full:
                    ax, axe = _twoprod(a, xb_)
                    p, pse = _twosum(ax, b)
                    pe = pe0 + (axe + pse)
                    t1, e1 = _twoprod(p, lam_c)
                    t2, e2 = _twoprod(c, lam_p)
                    s, se = _twosum(t1, t2)
                    lo = ((p * lam_cl + c * lam_pl)
                          + ((pe * lam_c + cl * lam_p)
                             + (se + (e1 + e2))))
                else:
                    p = a * xb_ + b
                    pe = pe0
                    t1 = p * lam_c
                    t2 = c * lam_p
                    s, se = _twosum(t1, t2)
                    lo = ((p * lam_cl + c * lam_pl)
                          + ((pe * lam_c + cl * lam_p) + se))
                lam_n, lam_nl = _twosum(s, lo)
            else:
                lam_n = (a * x[None, None, :] + b) * lam_c + c * lam_p
                lam_nl = lam_cl  # unused
            # seed injection where l == l0(m)
            is_seed = (l0 == l)[:, :, None]
            lam_n = jnp.where(is_seed, seed_m, lam_n)
            lam_pn = jnp.where(is_seed, jnp.zeros_like(lam_c), lam_c)
            e = jnp.where(is_seed, seed_e, e)
            if comp:
                lam_nl = jnp.where(is_seed, seed_lo, lam_nl)
                lam_pnl = jnp.where(is_seed, jnp.zeros_like(lam_cl), lam_cl)
            else:
                lam_pnl = lam_pl
            # unwind the extended exponent as values climb
            big = (jnp.abs(lam_n) > thresh) & (e > 0)
            lam_n = jnp.where(big, lam_n * inv_r, lam_n)
            lam_pn = jnp.where(big, lam_pn * inv_r, lam_pn)
            if comp:
                lam_nl = jnp.where(big, lam_nl * inv_r, lam_nl)
                lam_pnl = jnp.where(big, lam_pnl * inv_r, lam_pnl)
            e = jnp.where(big, e - 1, e)
            # effective (true) values: e==0 exact, e==1 one suppression,
            # e>=2 negligible (< 2^-45)
            w = jnp.where(e == 0, jnp.ones((), dtype),
                          jnp.where(e == 1, inv_r, jnp.zeros((), dtype)))
            lams.append(lam_n * w)
            lam_p, lam_c = lam_pn, lam_n
            lam_pl, lam_cl = lam_pnl, lam_nl
        lam_blk = jnp.stack(lams)              # (block, nn, M+1, T)
        out = contract(lsb[0], lam_blk, out, xb)
        return (lam_p, lam_c, lam_pl, lam_cl, e, out), None

    ls = jnp.arange(Lpad).reshape(nb, block)
    if xs is None:
        xs = jnp.zeros((nb, block), dtype)
    else:
        xs = jax.tree_util.tree_map(
            lambda v: jnp.reshape(
                jnp.concatenate(
                    [v, jnp.zeros((Lpad - L1,) + v.shape[1:], v.dtype)],
                    axis=0),
                (nb, block) + v.shape[1:]),
            xs)
    carry0 = (lam_p, lam_c, lam_pl, lam_cl, e, init_out)
    if vary_axes:
        # under shard_map, replicated initial carries must be promoted
        # to device-varying to match the theta-derived scan outputs
        if hasattr(jax.lax, "pcast"):            # pvary deprecated
            pv = lambda v: jax.lax.pcast(v, tuple(vary_axes),
                                         to="varying")
        else:
            pv = lambda v: jax.lax.pvary(v, tuple(vary_axes))
        carry0 = jax.tree_util.tree_map(pv, carry0)
        xs = jax.tree_util.tree_map(pv, xs)
        A, B, C, Al, Bl, Cl, ls = (pv(A), pv(B), pv(C), pv(Al), pv(Bl),
                                   pv(Cl), pv(ls))
    out = lax.scan(step, carry0, (A, B, C, Al, Bl, Cl, ls, xs))[0][-1]
    return out


# ---------------------------------------------------------------------------
# Packing helpers: (l, m) matrix <-> healpy triangular order
# ---------------------------------------------------------------------------

@lru_cache(maxsize=32)
def _pack_indices(lmax: int):
    ls, ms = almops.lm_indices(lmax)
    flat = ls.astype(np.int64) * (lmax + 1) + ms.astype(np.int64)
    return np.asarray(flat)


def _mat2alm(mat, lmax):
    """(..., L+1, M+1) -> healpy-packed (..., nalm)."""
    idx = jnp.asarray(_pack_indices(lmax))
    flatmat = mat.reshape(mat.shape[:-2] + (-1,))
    return jnp.take(flatmat, idx, axis=-1)


def _alm2mat(alm, lmax):
    """healpy-packed (..., nalm) -> (..., L+1, M+1) with zeros elsewhere."""
    idx = _pack_indices(lmax)
    n = (lmax + 1) * (lmax + 1)
    base = jnp.zeros(alm.shape[:-1] + (n,), alm.dtype)
    mat = base.at[..., jnp.asarray(idx)].set(alm)
    return mat.reshape(alm.shape[:-1] + (lmax + 1, lmax + 1))


# ---------------------------------------------------------------------------
# Ring FFTs
# ---------------------------------------------------------------------------

def _ring_analysis(maps, rings: RingGeom, mmax: int):
    """FFT each ring; return F[..., T, M+1] = sum_j f e^{-i m phi_j}."""
    nphi = rings.nphi
    if nphi < 2 * mmax + 1:
        raise ValueError(
            f"nphi={nphi} < 2*mmax+1={2*mmax+1}: ring FFT would alias")
    if maps.shape[-1] != nphi:
        raise ValueError(
            f"map phi axis {maps.shape[-1]} != rings.nphi {nphi}: the "
            "quadrature normalization and sample phases would be wrong")
    F = jnp.fft.rfft(maps, axis=-1)[..., : mmax + 1]
    m = jnp.arange(mmax + 1)
    phase = jnp.exp(-1j * m * rings.phi0).astype(F.dtype)
    return F * phase


def _ring_synthesis(Fm, rings: RingGeom, real: bool):
    """Inverse of `_ring_analysis`: Fm[..., T, M+1] -> maps[..., T, nphi].

    For ``real=True`` the negative-m part is the conjugate (irfft);
    otherwise the caller passes the full-plane coefficients separately.
    """
    nphi = rings.nphi
    mmax = Fm.shape[-1] - 1
    m = jnp.arange(mmax + 1)
    phase = jnp.exp(1j * m * rings.phi0).astype(Fm.dtype)
    X = Fm * phase
    if nphi < 2 * mmax + 1:
        # mmax == nphi/2 (even nphi) would land the top mode on the
        # irfft Nyquist bin: silently halved, imaginary part dropped —
        # mirror the analysis direction's hard error instead
        raise ValueError("nphi too small for mmax (synthesis would "
                         "alias the top m onto the Nyquist bin)")
    pad = nphi // 2 + 1 - (mmax + 1)
    X = jnp.pad(X, [(0, 0)] * (X.ndim - 1) + [(0, pad)])
    return jnp.fft.irfft(X, n=nphi, axis=-1) * nphi


# ---------------------------------------------------------------------------
# Spin-0 transforms
# ---------------------------------------------------------------------------

def _real_dtype(dtype):
    return jnp.finfo(dtype).dtype if jnp.issubdtype(dtype, jnp.floating) \
        else jnp.float32


def _tables_for(rings: RingGeom, lmax, ns, real_dtype):
    """Cached device scan-tables for a (rings, lmax, ns, dtype) combo.

    Called OUTSIDE the jit boundary so the O(lmax^2) tables enter the
    compiled program as arguments, not constants (see
    :func:`_scan_tables_host`). When a transform is itself traced
    inside an outer jit this degrades gracefully: the concrete device
    arrays become outer-program constants, which is exactly the old
    behavior."""
    rdt = np.dtype(real_dtype)
    mode = _mode_for(rdt)
    return _scan_tables_dev(lmax, tuple(ns), rdt.str, rings.theta, mode)


def map2alm(maps, rings: RingGeom, lmax: int):
    """Analysis: (..., ntheta, nphi) real map(s) -> healpy-packed alm.

    Exact for band-limited inputs when ``rings`` carries an exact
    quadrature (Gauss-Legendre always; Clenshaw-Curtis for
    ``ntheta >= 2 lmax + 1``... see constructor docs).
    """
    maps = jnp.asarray(maps)
    tables = _tables_for(rings, lmax, (0,), maps.dtype)
    return _map2alm_impl(maps, tables, rings=rings, lmax=lmax)


@partial(jax.jit, static_argnames=("rings", "lmax"))
def _map2alm_impl(maps, tables, *, rings: RingGeom, lmax: int):
    rdt = maps.dtype
    cdt = jnp.result_type(rdt, jnp.complex64)
    theta = rings.theta_array()
    w = jnp.asarray(rings.weights_array(), rdt) * (2.0 * np.pi / rings.nphi)
    F = _ring_analysis(maps, rings, lmax)          # (..., T, M+1)
    G = F * w[..., :, None]                        # weighted

    batch = maps.shape[:-2]
    Lpad = -(-(lmax + 1) // _LBLOCK) * _LBLOCK
    out0 = jnp.zeros(batch + (Lpad, lmax + 1), cdt)

    def contract(l_base, lam_blk, out, _):
        lam = lam_blk[:, 0]                        # (block, M+1, T)
        rows = jnp.einsum("lmt,...tm->...lm", lam, G,
                           precision=_EPREC).astype(cdt)
        return lax.dynamic_update_slice_in_dim(out, rows, l_base, axis=-2)

    mat = _lambda_scan(lmax, theta, (0,), rdt, contract, out0,
                       tables=tables)
    return _mat2alm(mat[..., : lmax + 1, :], lmax)


def alm2map(alm, rings: RingGeom, lmax: int = None):
    """Synthesis: healpy-packed alm -> real map(s) (..., ntheta, nphi)."""
    alm = jnp.asarray(alm)
    if lmax is None:
        lmax = almops.getlmax(alm.shape[-1])
    rdt = np.zeros((), np.dtype(alm.dtype)).real.dtype
    tables = _tables_for(rings, lmax, (0,), rdt)
    return _alm2map_impl(alm, tables, rings=rings, lmax=lmax)


@partial(jax.jit, static_argnames=("rings", "lmax"))
def _alm2map_impl(alm, tables, *, rings: RingGeom, lmax: int):
    cdt = alm.dtype
    rdt = jnp.real(jnp.zeros((), cdt)).dtype
    theta = rings.theta_array()
    mat = _alm2mat(alm, lmax)                      # (..., L+1, M+1)
    batch = alm.shape[:-1]
    T = rings.ntheta
    acc0 = jnp.zeros(batch + (T, lmax + 1), cdt)
    # m=0 term counts once; m>0 handled by irfft conjugate symmetry.
    mat = jnp.moveaxis(mat, -2, 0)                 # (L+1, ..., M+1)

    def contract(l_base, lam_blk, out, a_blk):
        lam = lam_blk[:, 0]                        # (block, M+1, T)
        return out + jnp.einsum("lmt,l...m->...tm", lam, a_blk,
                         precision=_EPREC)

    acc = _lambda_scan(lmax, theta, (0,), rdt, contract, acc0, xs=mat,
                       tables=tables)
    return _ring_synthesis(acc, rings, real=True).astype(rdt)


# ---------------------------------------------------------------------------
# Spin-s transforms (E/B <-> Q/U for s = 2)
# ---------------------------------------------------------------------------

def alm2map_spin(ealm, balm, rings: RingGeom, lmax: int = None, spin: int = 2):
    """Synthesis of a spin-``s`` field: (E, B) alms -> (Q, U)-like maps.

    Convention: ``a_{±s} = -(E ± iB)``, ``(Q ± iU) = sum a_{±s} {}_{±s}Y``
    (healpy / Zaldarriaga-Seljak for s = 2).
    """
    if spin % 2:
        raise NotImplementedError(
            "odd spins: the real-pair convention (Q -+ iU Hermitian "
            "reconstruction) is only valid for even spin")
    ealm = jnp.asarray(ealm); balm = jnp.asarray(balm)
    if lmax is None:
        lmax = almops.getlmax(ealm.shape[-1])
    rdt = np.zeros((), np.dtype(ealm.dtype)).real.dtype
    tables = _tables_for(rings, lmax, (-spin, spin), rdt)
    return _alm2map_spin_impl(ealm, balm, tables, rings=rings, lmax=lmax,
                              spin=spin)


@partial(jax.jit, static_argnames=("rings", "lmax", "spin"))
def _alm2map_spin_impl(ealm, balm, tables, *, rings: RingGeom, lmax: int,
                       spin: int):
    cdt = ealm.dtype
    rdt = jnp.real(jnp.zeros((), cdt)).dtype
    theta = rings.theta_array()
    emat = jnp.moveaxis(_alm2mat(ealm, lmax), -2, 0)
    bmat = jnp.moveaxis(_alm2mat(balm, lmax), -2, 0)
    batch = ealm.shape[:-1]
    T = rings.ntheta
    acc0 = jnp.zeros((2,) + batch + (T, lmax + 1), cdt)

    def contract(l_base, lam_blk, out, ab):
        a_blk, b_blk = ab
        # lam_blk[:, 0] = Lambda^{m,-s}, lam_blk[:, 1] = Lambda^{m,+s}
        W = 0.5 * (lam_blk[:, 0] + lam_blk[:, 1])  # (block, M+1, T)
        X = 0.5 * (lam_blk[:, 0] - lam_blk[:, 1])
        # Q_m += -(E W + i B X);  U_m += -(B W - i E X)
        q = -(jnp.einsum("lmt,l...m->...tm", W, a_blk, precision=_EPREC)
              + 1j * jnp.einsum("lmt,l...m->...tm", X, b_blk, precision=_EPREC))
        u = -(jnp.einsum("lmt,l...m->...tm", W, b_blk, precision=_EPREC)
              - 1j * jnp.einsum("lmt,l...m->...tm", X, a_blk, precision=_EPREC))
        return out.at[0].add(q).at[1].add(u)

    acc = _lambda_scan(lmax, theta, (-spin, spin), rdt, contract, acc0,
                       xs=(emat, bmat), tables=tables)
    q = _ring_synthesis(acc[0], rings, real=True)
    u = _ring_synthesis(acc[1], rings, real=True)
    return q.astype(rdt), u.astype(rdt)


def map2alm_spin(qmap, umap, rings: RingGeom, lmax: int, spin: int = 2):
    """Analysis of a spin-``s`` field: (Q, U)-like maps -> (E, B) alms.
    Even spins only (see :func:`alm2map_spin`)."""
    if spin % 2:
        raise NotImplementedError(
            "odd spins: the real-pair convention (Q -+ iU Hermitian "
            "reconstruction) is only valid for even spin")
    qmap = jnp.asarray(qmap); umap = jnp.asarray(umap)
    tables = _tables_for(rings, lmax, (-spin, spin), qmap.dtype)
    return _map2alm_spin_impl(qmap, umap, tables, rings=rings, lmax=lmax,
                              spin=spin)


def _spin_ring_analysis(qmap, umap, rings: RingGeom, lmax: int):
    """Ring-FFT preamble of the spin analyses (serial and
    ring-distributed): F± = FFT(Q ± iU) truncated to the +m frequencies
    with the phi0 phase applied, and the quadrature weights
    w = ring_weights * 2pi/nphi in the input's real dtype.
    Returns (Fp, Fm, w)."""
    rdt = qmap.dtype
    cdt = jnp.result_type(rdt, jnp.complex64)
    if rings.nphi < 2 * lmax + 1:
        raise ValueError("nphi too small for requested lmax")
    w = jnp.asarray(rings.weights_array(), rdt) * (2.0 * np.pi / rings.nphi)
    p_plus = qmap.astype(cdt) + 1j * umap.astype(cdt)
    m = np.arange(lmax + 1)
    phase = jnp.exp(-1j * jnp.asarray(m) * rings.phi0).astype(cdt)
    # ONE complex FFT serves both: P- = conj(P+), so
    # fft(P-)[m] = conj(fft(P+)[-m]) — the second full FFT is a
    # conjugated negative-frequency gather of the first (exact)
    F = jnp.fft.fft(p_plus, axis=-1)
    Fp = F[..., : lmax + 1] * phase
    Fm = jnp.conj(F[..., jnp.asarray((-m) % rings.nphi)]) * phase
    return Fp, Fm, w


@partial(jax.jit, static_argnames=("rings", "lmax", "spin"))
def _map2alm_spin_impl(qmap, umap, tables, *, rings: RingGeom, lmax: int,
                       spin: int):
    rdt = qmap.dtype
    cdt = jnp.result_type(rdt, jnp.complex64)
    theta = rings.theta_array()
    # a+_lm = sum w Lambda^{m,-s} Fp_m ; a-_lm = sum w Lambda^{m,+s} Fm_m
    # with Fp = fft(Q + iU), Fm = fft(Q - iU) at +m frequencies.
    Fp, Fm, w = _spin_ring_analysis(qmap, umap, rings, lmax)
    Gp = Fp * w[..., :, None]
    Gm = Fm * w[..., :, None]

    batch = qmap.shape[:-2]
    Lpad = -(-(lmax + 1) // _LBLOCK) * _LBLOCK
    out0 = jnp.zeros((2,) + batch + (Lpad, lmax + 1), cdt)

    def contract(l_base, lam_blk, out, _):
        ap = jnp.einsum("lmt,...tm->...lm", lam_blk[:, 0], Gp, precision=_EPREC)
        am = jnp.einsum("lmt,...tm->...lm", lam_blk[:, 1], Gm, precision=_EPREC)
        # E = -(a+ + a-)/2 ; B = i (a+ - a-)/2
        rows = jnp.stack([-0.5 * (ap + am), 0.5j * (ap - am)]).astype(cdt)
        return lax.dynamic_update_slice_in_dim(out, rows, l_base, axis=-2)

    mat = _lambda_scan(lmax, theta, (-spin, spin), rdt, contract, out0,
                       tables=tables)
    mat = mat[..., : lmax + 1, :]
    return _mat2alm(mat[0], lmax), _mat2alm(mat[1], lmax)


def map2alm_pol(tqu, rings: RingGeom, lmax: int):
    """(3, ntheta, nphi) T,Q,U maps -> (T, E, B) packed alms stacked."""
    t = map2alm(tqu[..., 0, :, :], rings, lmax)
    e, b = map2alm_spin(tqu[..., 1, :, :], tqu[..., 2, :, :], rings, lmax)
    return jnp.stack([t, e, b], axis=-2)


def alm2map_pol(teb, rings: RingGeom, lmax: int = None):
    """(3, nalm) T,E,B alms -> (3, ntheta, nphi) T,Q,U maps."""
    t = alm2map(teb[..., 0, :], rings, lmax)
    q, u = alm2map_spin(teb[..., 1, :], teb[..., 2, :], rings, lmax)
    return jnp.stack([t, q, u], axis=-3)
