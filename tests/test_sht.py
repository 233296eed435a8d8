"""Spherical-harmonic transform validation.

Strategy (mirrors the reference's own validation style for curved-sky
code, which leans on healpy/pixell as ground truth): here the ground
truth is (a) scipy's spherical harmonics for spin-0, (b) a brute-force
Wigner-d sum formula at small l for the spin columns, (c) machine-
precision roundtrips and per-l spectrum recovery at full scale.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy.special import gammaln

from orphics_tpu.ops import sht
from orphics_tpu.ops import alm as almops


def wigner_d_brute(l, m, n, beta):
    """Explicit Wigner small-d sum formula (f64; stable for small l)."""
    smin = max(0, n - m)
    smax = min(l + n, l - m)
    if smax < smin:
        return np.zeros_like(np.asarray(beta, float))
    c = np.cos(beta / 2.0)
    s = np.sin(beta / 2.0)
    lf = lambda v: gammaln(v + 1.0)
    pref = 0.5 * (lf(l + m) + lf(l - m) + lf(l + n) + lf(l - n))
    tot = 0.0
    for k in range(smin, smax + 1):
        lt = pref - lf(l + n - k) - lf(k) - lf(m - n + k) - lf(l - m - k)
        tot = tot + (-1.0) ** (m - n + k) * np.exp(lt) \
            * c ** (2 * l + n - m - 2 * k) * s ** (m - n + 2 * k)
    return tot


def get_lambda(lmax, theta, n):
    """Extract Lambda^{m,n}_l(theta) for all (l, m) from the scan."""
    T = len(theta)
    Lpad = -(-(lmax + 1) // sht._LBLOCK) * sht._LBLOCK
    out0 = jnp.zeros((Lpad, lmax + 1, T))

    def contract(l_base, lam_blk, out, _):
        from jax import lax
        return lax.dynamic_update_slice_in_dim(out, lam_blk[:, 0], l_base,
                                               axis=0)

    out = sht._lambda_scan(lmax, np.asarray(theta), (n,),
                           jnp.float64, contract, out0)
    return np.asarray(out)[: lmax + 1]


THETAS = np.array([0.013, 0.3, 1.0, np.pi / 2, 2.2, np.pi - 0.013])


class TestWigner:
    def test_spin0_vs_scipy(self):
        from scipy.special import sph_harm_y
        lmax = 40
        lam = get_lambda(lmax, THETAS, 0)
        for l in range(lmax + 1):
            for m in range(l + 1):
                want = np.array([sph_harm_y(l, m, t, 0.0).real
                                 for t in THETAS])
                np.testing.assert_allclose(lam[l, m], want, atol=1e-12)

    @pytest.mark.parametrize("n", [-2, 2, -1, 3])
    def test_spin_columns_vs_brute(self, n):
        lmax = 12
        lam = get_lambda(lmax, THETAS, n)
        for l in range(abs(n), lmax + 1):
            norm = np.sqrt((2 * l + 1) / (4 * np.pi))
            for m in range(l + 1):
                want = wigner_d_brute(l, m, n, THETAS) * norm
                np.testing.assert_allclose(lam[l, m], want, atol=1e-11)

    def test_lambda_zero_below_l0(self):
        lam = get_lambda(8, THETAS, -2)
        assert np.all(lam[0] == 0) and np.all(lam[1] == 0)
        # m > l also zero
        assert np.all(lam[3, 5:] == 0)


def _random_alm(key, lmax, lmin=0, dtype=jnp.complex128):
    cl = 1.0 / (np.arange(lmax + 1) + 10.0) ** 2
    a = almops.synalm(key, jnp.asarray(cl), lmax=lmax, dtype=dtype)
    if lmin > 0:
        ls, _ = almops.lm_indices(lmax)
        a = a * (jnp.asarray(ls) >= lmin)
    return a


class TestRoundtrip:
    @pytest.mark.parametrize("grid", ["gl", "cc"])
    def test_spin0_f64(self, grid):
        lmax = 63
        rings = (sht.gauss_legendre_rings(lmax) if grid == "gl"
                 else sht.clenshaw_curtis_rings(2 * lmax + 2))
        a0 = _random_alm(jax.random.PRNGKey(0), lmax)
        m = sht.alm2map(a0, rings, lmax)
        a1 = sht.map2alm(m, rings, lmax)
        err = np.max(np.abs(np.asarray(a1 - a0)))
        assert err < 1e-12 * np.max(np.abs(np.asarray(a0)))

    def test_spin2_f64(self):
        lmax = 63
        rings = sht.gauss_legendre_rings(lmax)
        ae = _random_alm(jax.random.PRNGKey(1), lmax, lmin=2)
        ab = _random_alm(jax.random.PRNGKey(2), lmax, lmin=2)
        q, u = sht.alm2map_spin(ae, ab, rings, lmax)
        ae1, ab1 = sht.map2alm_spin(q, u, rings, lmax)
        scale = np.max(np.abs(np.asarray(ae)))
        assert np.max(np.abs(np.asarray(ae1 - ae))) < 1e-12 * scale
        assert np.max(np.abs(np.asarray(ab1 - ab))) < 1e-12 * scale

    def test_f32_high_lmax(self):
        """fp32 path with extended-exponent rescaling (seeds underflow
        fp32 at m ~ 100s near the poles; a broken rescale shows O(1)
        errors here)."""
        lmax = 255
        rings = sht.gauss_legendre_rings(lmax)
        a0 = _random_alm(jax.random.PRNGKey(3), lmax, dtype=jnp.complex64)
        m = sht.alm2map(a0, rings, lmax)
        assert m.dtype == jnp.float32
        a1 = sht.map2alm(m, rings, lmax)
        cl0 = np.asarray(almops.alm2cl(a0))
        cl1 = np.asarray(almops.alm2cl(a1))
        np.testing.assert_allclose(cl1[2:], cl0[2:], rtol=2e-4)

    def test_f32_compensated_modes(self):
        """The fp32 recurrence compensation ladder (sht._COMPENSATE):
        "full" (Dekker TwoProd dd, the default) must land the fp32
        roundtrip at the few-ulp level — two orders of magnitude below
        plain fp32 — and "lite" in between. Guards both the dd algebra
        and the device-argument table plumbing (_scan_tables_host)."""
        lmax = 255
        rings = sht.gauss_legendre_rings(lmax)
        a0 = _random_alm(jax.random.PRNGKey(5), lmax, dtype=jnp.complex64)
        errs = {}
        old = sht._COMPENSATE
        try:
            for mode in ("off", "lite", "full"):
                sht._COMPENSATE = mode
                jax.clear_caches()
                m = sht.alm2map(a0, rings, lmax)
                a1 = sht.map2alm(m, rings, lmax)
                errs[mode] = float(np.max(np.abs(np.asarray(a1 - a0))))
        finally:
            sht._COMPENSATE = old
            jax.clear_caches()
        scale = float(np.max(np.abs(np.asarray(a0))))
        assert errs["full"] < 2e-6 * scale, errs
        assert errs["full"] < 0.05 * errs["off"], errs
        assert errs["lite"] <= errs["off"] * 1.05, errs

    def test_outer_jit_no_tracer_leak(self):
        """Transforms called under an OUTER jit must not poison the
        device-table caches with tracers (regression: _scan_tables_dev
        cached `jnp.asarray` results, which are tracers
        inside a trace -> UnexpectedTracerError on the next call). Run
        traced first, then eager, then traced again with a different
        closure — all three must agree."""
        lmax = 31
        rings = sht.gauss_legendre_rings(lmax)
        a0 = _random_alm(jax.random.PRNGKey(11), lmax)

        @jax.jit
        def traced(a):
            return sht.map2alm(sht.alm2map(a, rings, lmax), rings, lmax)

        r1 = traced(a0)
        r2 = sht.map2alm(sht.alm2map(a0, rings, lmax), rings, lmax)
        r3 = jax.jit(lambda a: sht.alm2map(a, rings, lmax))(a0)
        np.testing.assert_allclose(np.asarray(r1), np.asarray(a0),
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(r2), np.asarray(a0),
                                   atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(r3), np.asarray(sht.alm2map(a0, rings, lmax)),
            atol=1e-12)

    def test_batched(self):
        lmax = 31
        rings = sht.gauss_legendre_rings(lmax)
        alms = jnp.stack([_random_alm(jax.random.PRNGKey(i), lmax)
                          for i in range(3)])
        maps = sht.alm2map(alms, rings, lmax)
        assert maps.shape == (3,) + rings.shape
        back = sht.map2alm(maps, rings, lmax)
        np.testing.assert_allclose(np.asarray(back), np.asarray(alms),
                                   atol=1e-12)

    def test_pol_stack(self):
        lmax = 31
        rings = sht.gauss_legendre_rings(lmax)
        teb = jnp.stack([_random_alm(jax.random.PRNGKey(i), lmax, lmin=2)
                         for i in range(3)])
        tqu = sht.alm2map_pol(teb, rings, lmax)
        assert tqu.shape == (3,) + rings.shape
        teb1 = sht.map2alm_pol(tqu, rings, lmax)
        np.testing.assert_allclose(np.asarray(teb1), np.asarray(teb),
                                   atol=1e-12)


class TestConventions:
    def test_monopole_dipole(self):
        """A constant map is sqrt(4pi) a_00; Y_10 synthesis matches the
        explicit formula sqrt(3/4pi) cos(theta)."""
        lmax = 8
        rings = sht.gauss_legendre_rings(lmax)
        const = jnp.ones(rings.shape)
        a = np.asarray(sht.map2alm(const, rings, lmax))
        assert abs(a[0] - np.sqrt(4 * np.pi)) < 1e-12
        assert np.max(np.abs(a[1:])) < 1e-12

        a10 = jnp.zeros(almops.nalm(lmax), jnp.complex128).at[1].set(1.0)
        m = np.asarray(sht.alm2map(a10, rings, lmax))
        theta = rings.theta_array()
        want = np.sqrt(3 / (4 * np.pi)) * np.cos(theta)
        np.testing.assert_allclose(m[:, 0], want, atol=1e-12)

    def test_y11_condon_shortley(self):
        """Y_11 = -sqrt(3/8pi) sin(theta) e^{i phi} (CS phase, healpy)."""
        lmax = 4
        rings = sht.gauss_legendre_rings(lmax)
        idx_11 = lmax + 1  # packed index of (l=1, m=1)
        a = jnp.zeros(almops.nalm(lmax), jnp.complex128).at[idx_11].set(1.0)
        m = np.asarray(sht.alm2map(a, rings, lmax))
        theta = rings.theta_array()
        phi = rings.phi0 + 2 * np.pi * np.arange(rings.nphi) / rings.nphi
        # real field synthesis: a_11 Y_11 + a_1,-1 Y_1,-1 with
        # a_1,-1 = -conj(a_11) => 2 Re[Y_11]
        want = 2 * (-np.sqrt(3 / (8 * np.pi))) * np.outer(
            np.sin(theta), np.cos(phi))
        np.testing.assert_allclose(m, want, atol=1e-12)

    def test_spin2_brute_synthesis(self):
        """alm2map_spin against a brute-force sum over explicit
        spin-weighted harmonics sY_lm = (-1)^s N_l d^l_{m,-s} e^{im phi},
        with (Q+iU) = -sum (E+iB) 2Y (healpy/ZS convention)."""
        lmax = 6
        rings = sht.gauss_legendre_rings(lmax, nphi=16)
        ae = _random_alm(jax.random.PRNGKey(5), lmax, lmin=2)
        ab = _random_alm(jax.random.PRNGKey(6), lmax, lmin=2)
        q, u = sht.alm2map_spin(ae, ab, rings, lmax)

        theta = rings.theta_array()
        phi = rings.phi0 + 2 * np.pi * np.arange(rings.nphi) / rings.nphi
        ls, ms = almops.lm_indices(lmax)
        aE = np.asarray(ae)
        aB = np.asarray(ab)
        P = np.zeros((len(theta), len(phi)), complex)  # Q + iU
        for l in range(2, lmax + 1):
            norm = np.sqrt((2 * l + 1) / (4 * np.pi))
            for m in range(-l, l + 1):
                if m >= 0:
                    i = almops.nalm(lmax) * 0 + m * (2 * lmax + 1 - m) // 2 + l
                    E, B = aE[i], aB[i]
                else:
                    i = (-m) * (2 * lmax + 1 + m) // 2 + l
                    E = (-1) ** m * np.conj(aE[i])
                    B = (-1) ** m * np.conj(aB[i])
                sY = norm * wigner_d_brute(l, m, -2, theta)[:, None] \
                    * np.exp(1j * m * phi)[None, :]
                P += -(E + 1j * B) * sY
        np.testing.assert_allclose(np.asarray(q), P.real, atol=1e-10)
        np.testing.assert_allclose(np.asarray(u), P.imag, atol=1e-10)


class TestQuadrature:
    def test_cc_weights_exact(self):
        rings = sht.clenshaw_curtis_rings(33)
        theta = rings.theta_array()
        w = rings.weights_array()
        for k in range(0, 30):
            want = (1 + np.cos(np.pi * k)) / (1 - k ** 2) if k != 1 else 0.0
            got = np.sum(w * np.cos(k * theta))
            assert abs(got - want) < 1e-12, k

    def test_gl_weights_exact(self):
        rings = sht.gauss_legendre_rings(16)
        x = np.cos(rings.theta_array())
        w = rings.weights_array()
        for p in range(0, 33):
            want = (1 - (-1) ** (p + 1)) / (p + 1)
            assert abs(np.sum(w * x ** p) - want) < 1e-12, p

    def test_nphi_alias_guard(self):
        rings = sht.gauss_legendre_rings(16, nphi=8)
        with pytest.raises(ValueError):
            sht.map2alm(jnp.ones(rings.shape), rings, 16)


class TestValidation:
    """Review regressions: silent-wrong-output paths now raise."""

    def test_odd_spin_rejected(self):
        lmax = 15
        rings = sht.gauss_legendre_rings(lmax)
        a = _random_alm(jax.random.PRNGKey(0), lmax, lmin=1)
        with pytest.raises(NotImplementedError, match="even spin"):
            sht.alm2map_spin(a, a, rings, lmax, spin=1)
        m = jnp.zeros(rings.shape)
        with pytest.raises(NotImplementedError, match="even spin"):
            sht.map2alm_spin(m, m, rings, lmax, spin=3)

    def test_synthesis_nyquist_guard(self):
        """nphi == 2*mmax (even) used to silently halve the top-m mode
        on the irfft Nyquist bin; now mirrors the analysis error."""
        lmax = 4
        rings = sht.gauss_legendre_rings(lmax, nphi=8)  # 8 == 2*lmax
        a = _random_alm(jax.random.PRNGKey(1), lmax)
        with pytest.raises(ValueError, match="alias"):
            sht.alm2map(a, rings, lmax)

    def test_map_nphi_mismatch_rejected(self):
        lmax = 15
        rings = sht.gauss_legendre_rings(lmax)
        bad = jnp.zeros((rings.ntheta, rings.nphi + 4))
        with pytest.raises(ValueError, match="nphi"):
            sht.map2alm(bad, rings, lmax)

    def test_getlmax_zero_rejected(self):
        with pytest.raises(ValueError, match="alm length"):
            almops.getlmax(0)

    def test_alm2cl_stacked(self):
        """alm2cl on a (B, nalm) stack (the healpy array contract)
        equals per-row alm2cl."""
        lmax = 15
        alms = jnp.stack([_random_alm(jax.random.PRNGKey(i), lmax)
                          for i in range(3)])
        cls = np.asarray(almops.alm2cl(alms))
        assert cls.shape == (3, lmax + 1)
        for i in range(3):
            np.testing.assert_allclose(
                cls[i], np.asarray(almops.alm2cl(alms[i])), rtol=1e-12)


