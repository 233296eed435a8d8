"""Closed-form tests of the mesh statistics runtime, parameterized by
device count — the reference's pattern of writing MPI-reducer expectations
as functions of world size (``orphics/tests/test_stats.py``), here executed
on a genuine 8-device virtual CPU mesh.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orphics_tpu.parallel import (SuffStats, Statistics, get_stats, get_mesh,
                                  mpi_distribute, ensemble, ensemble_stats)


def test_mpi_distribute_policy():
    """Remainder goes to the last ranks (reference orphics/mpi.py:83);
    return signature is the reference's (num_each, task_dist) tuple."""
    counts, chunks = mpi_distribute(10, 4)
    assert list(counts) == [2, 2, 3, 3]
    assert [len(c) for c in chunks] == [2, 2, 3, 3]
    assert sum(chunks, []) == list(range(10))
    counts, chunks = mpi_distribute(8, 4)
    assert list(counts) == [2, 2, 2, 2]


def test_suffstats_mean_cov_closed_form():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((500, 7)).astype(np.float64)
    st = SuffStats.zeros(7, dtype=jnp.float64).add(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(st.mean()), x.mean(axis=0), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(st.cov()), np.cov(x.T, ddof=1),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(st.var()), x.var(axis=0, ddof=1),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(st.corr()), np.corrcoef(x.T),
                               rtol=1e-7, atol=1e-10)


def test_suffstats_merge_equals_concat():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((100, 3))
    b = rng.standard_normal((37, 3))
    st1 = SuffStats.zeros(3, dtype=jnp.float64).add(jnp.asarray(a))
    st2 = SuffStats.zeros(3, dtype=jnp.float64).add(jnp.asarray(b))
    merged = st1.merge(st2)
    both = SuffStats.zeros(3, dtype=jnp.float64).add(jnp.asarray(np.vstack([a, b])))
    np.testing.assert_allclose(np.asarray(merged.cov()), np.asarray(both.cov()),
                               rtol=1e-10)


def test_statistics_roundtrip_save_load(tmp_path):
    rng = np.random.default_rng(2)
    s = Statistics()
    for _ in range(5):
        s.extend("p1d", jnp.asarray(rng.standard_normal((8, 4))))
    s.add_stack("m", jnp.asarray(rng.standard_normal((6, 6))))
    fname = str(tmp_path / "red.npz")
    s.save_reduced(fname)
    s2 = Statistics.load_reduced(fname)
    np.testing.assert_allclose(np.asarray(s2.mean("p1d")),
                               np.asarray(s.mean("p1d")))
    np.testing.assert_allclose(np.asarray(s2.cov("p1d")),
                               np.asarray(s.cov("p1d")))
    np.testing.assert_allclose(np.asarray(s2.stack_mean("m")),
                               np.asarray(s.stack_mean("m")))


def test_ensemble_stats_on_mesh():
    """The psum-reduced ensemble equals the serial computation exactly."""
    mesh = get_mesh()
    assert mesh.devices.size == 8

    def fn(key):
        x = jax.random.normal(key, (5,))
        return {"x": x, "y": 2.0 * x + 1.0}

    nsims = 64
    st = ensemble_stats(fn, nsims, key=jax.random.PRNGKey(3), mesh=mesh, chunk=4)
    assert int(st["x"].n) == nsims
    # serial recomputation with the same key-split
    keys = jax.random.split(jax.random.PRNGKey(3), nsims)
    xs = np.asarray(jax.vmap(lambda k: fn(k)["x"])(keys))
    np.testing.assert_allclose(np.asarray(st["x"].mean()), xs.mean(axis=0),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(st["x"].cov()),
                               np.cov(xs.T, ddof=1), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(st["y"].mean()),
                               2 * xs.mean(axis=0) + 1, rtol=2e-5, atol=1e-5)


def test_ensemble_gather_matches_vmap():
    def fn(key):
        return {"v": jax.random.normal(key, (3,))}

    out = ensemble(fn, 16, key=jax.random.PRNGKey(5))
    keys = jax.random.split(jax.random.PRNGKey(5), 16)
    expect = np.asarray(jax.vmap(lambda k: fn(k)["v"])(keys))
    np.testing.assert_allclose(np.asarray(out["v"]), expect, rtol=1e-6)


def test_get_stats_dict():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((50, 3))
    d = get_stats(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(d["mean"]), x.mean(axis=0), rtol=1e-4, atol=1e-6)
    # reference semantics: err = per-sample scatter, errmean = SEM
    np.testing.assert_allclose(np.asarray(d["err"]),
                               x.std(axis=0, ddof=1), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(d["errmean"]),
                               x.std(axis=0, ddof=1) / np.sqrt(50), rtol=1e-3)


def test_ensemble_stats_padding_excluded():
    """nsims not a multiple of ndev*chunk: padded sims must not bias the
    statistics (ADVICE round-1: previously the count was rounded up)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from orphics_tpu.parallel import ensemble_stats
    from orphics_tpu.parallel.runtime import get_mesh

    mesh = get_mesh()
    ndev = mesh.shape["sims"]
    nsims = ndev * 2 + 3  # deliberately ragged

    def sim(key):
        return {"x": jax.random.normal(key, (4,))}

    st = ensemble_stats(sim, nsims=nsims, key=jax.random.PRNGKey(5),
                        mesh=mesh, chunk=1)
    assert int(np.asarray(st["x"].n)) == nsims
    # serial reference over exactly the same first-nsims keys
    per = -(-nsims // ndev)
    keys = jax.random.split(jax.random.PRNGKey(5), ndev * per)
    vals = np.stack([np.asarray(sim(k)["x"]) for k in keys])
    # global order is device-major: key index d*per + i
    want = vals[np.arange(ndev * per) < nsims].mean(axis=0)
    np.testing.assert_allclose(np.asarray(st["x"].mean()), want,
                               rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def mesh8():
    return get_mesh()


class TestCurvedEnsemble:
    """Integration: curved-sky GRF Monte Carlo (rand_map -> map2alm ->
    alm2cl) through ensemble_stats over the sims mesh axis — the
    reference's mpi-distributed anafast loop as one sharded program."""

    def test_curved_mc_spectrum_recovery(self, mesh8):
        from orphics_tpu.ops import sht
        from orphics_tpu.ops import alm as almops
        from orphics_tpu.models import curved
        from orphics_tpu.parallel import ensemble_stats
        lmax = 24
        rings = sht.gauss_legendre_rings(lmax)
        cl = jnp.asarray(1.0 / (np.arange(lmax + 1) + 2.0) ** 2)

        def sim(key):
            m = curved.rand_map(key, rings, cl, lmax)
            return {"cl": almops.alm2cl(sht.map2alm(m, rings, lmax))}

        nsims = 32
        st = ensemble_stats(sim, nsims=nsims, key=jax.random.PRNGKey(7),
                            mesh=mesh8, chunk=2)
        assert int(np.asarray(st["cl"].n)) == nsims
        ratio = np.asarray(st["cl"].mean())[3:] / np.asarray(cl)[3:]
        # MC error ~ sqrt(2/(2l+1)/nsims) per l; mean over l's is tight
        assert abs(ratio.mean() - 1.0) < 0.1
        assert np.all(np.isfinite(np.asarray(st["cl"].cov())))


class TestCheckpointedEnsemble:
    """Preemption-safe ensembles: interrupted + resumed must equal the
    uninterrupted run bitwise, and resumes with different arguments
    must be refused."""

    def test_resume_bitwise(self, mesh8, tmp_path):
        from orphics_tpu.parallel import ensemble_stats_checkpointed

        def sim(key):
            return {"v": jax.random.normal(key, (5,))}

        key = jax.random.PRNGKey(3)
        full = ensemble_stats_checkpointed(
            sim, 24, str(tmp_path / "full.npz"), every=8, key=key,
            mesh=mesh8)
        assert int(np.asarray(full["v"].n)) == 24
        assert np.all(np.isfinite(np.asarray(full["v"].cov())))

        path = str(tmp_path / "ck.npz")
        out = ensemble_stats_checkpointed(sim, 24, path, every=8,
                                          key=key, mesh=mesh8,
                                          _interrupt_after=1)
        assert out is None                      # "preempted"
        import numpy as _np
        with _np.load(path) as z:
            assert int(z["rounds_done"]) == 1
        res = ensemble_stats_checkpointed(sim, 24, path, every=8,
                                          key=key, mesh=mesh8)
        for leaf in ("n", "s", "ss"):
            np.testing.assert_array_equal(
                np.asarray(getattr(res["v"], leaf)),
                np.asarray(getattr(full["v"], leaf)))

        with pytest.raises(ValueError):
            ensemble_stats_checkpointed(sim, 25, path, every=8,
                                        key=key, mesh=mesh8)

    def test_resume_with_stacks(self, mesh8, tmp_path):
        """Stack sums (the add_to_stack analog) survive the
        interrupt/resume cycle too."""
        from orphics_tpu.parallel import ensemble_stats_checkpointed

        def sim(key):
            return {"v": jax.random.normal(key, (3,))}

        def stack(key):
            return {"m": jax.random.normal(key, (4, 4))}

        key = jax.random.PRNGKey(5)
        kw = dict(every=8, key=key, mesh=mesh8, stack_fn=stack)
        full = ensemble_stats_checkpointed(
            sim, 20, str(tmp_path / "full.npz"), **kw)
        path = str(tmp_path / "ck.npz")
        assert ensemble_stats_checkpointed(sim, 20, path,
                                           _interrupt_after=1,
                                           **kw) is None
        res = ensemble_stats_checkpointed(sim, 20, path, **kw)
        assert int(np.asarray(res["m"].nstack)) == 20
        np.testing.assert_array_equal(np.asarray(res["m"].stack),
                                      np.asarray(full["m"].stack))
        np.testing.assert_array_equal(np.asarray(res["v"].ss),
                                      np.asarray(full["v"].ss))


class TestDistributedSHT:
    """Ring-distributed SHT (parallel/sht.py): shard_map + psum over the
    ring axis must match the serial transforms exactly."""

    def test_map2alm_dist_matches_serial(self, mesh8):
        from orphics_tpu.ops import sht
        from orphics_tpu.parallel import sht as psht
        lmax = 40
        rings = sht.gauss_legendre_rings(lmax)  # 41 rings -> padded to 48
        rng = np.random.default_rng(0)
        m = jnp.asarray(rng.standard_normal(rings.shape))
        a_ser = sht.map2alm(m, rings, lmax)
        a_dist = psht.map2alm_dist(m, rings, lmax, mesh8)
        np.testing.assert_allclose(np.asarray(jnp.abs(a_dist - a_ser)),
                                   0.0, atol=1e-10)

    def test_alm2map_dist_matches_serial(self, mesh8):
        from orphics_tpu.ops import sht
        from orphics_tpu.parallel import sht as psht
        lmax = 40
        rings = sht.gauss_legendre_rings(lmax)
        rng = np.random.default_rng(1)
        from orphics_tpu.ops import alm as almops
        ls, ms = almops.lm_indices(lmax)
        alm = (rng.standard_normal(ls.size)
               + 1j * np.where(ms == 0, 0.0,
                               rng.standard_normal(ls.size)))
        alm = jnp.asarray(alm)
        mp_ser = sht.alm2map(alm, rings, lmax)
        mp_dist = psht.alm2map_dist(alm, rings, lmax, mesh8)
        np.testing.assert_allclose(np.asarray(mp_dist),
                                   np.asarray(mp_ser), atol=1e-10)

    def test_dist_roundtrip(self, mesh8):
        """dist-analysis o dist-synthesis recovers the alm."""
        from orphics_tpu.ops import sht
        from orphics_tpu.ops import alm as almops
        from orphics_tpu.parallel import sht as psht
        lmax = 24
        rings = sht.gauss_legendre_rings(lmax)
        rng = np.random.default_rng(2)
        ls, ms = almops.lm_indices(lmax)
        alm = jnp.asarray(rng.standard_normal(ls.size)
                          + 1j * np.where(ms == 0, 0.0,
                                          rng.standard_normal(ls.size)))
        m = psht.alm2map_dist(alm, rings, lmax, mesh8)
        a2 = psht.map2alm_dist(m, rings, lmax, mesh8)
        np.testing.assert_allclose(np.asarray(a2), np.asarray(alm),
                                   atol=1e-8)

    def test_map2alm_spin_dist_matches_serial(self, mesh8):
        from orphics_tpu.ops import sht
        from orphics_tpu.parallel import sht as psht
        lmax = 32
        rings = sht.gauss_legendre_rings(lmax)
        rng = np.random.default_rng(3)
        q = jnp.asarray(rng.standard_normal(rings.shape))
        u = jnp.asarray(rng.standard_normal(rings.shape))
        e_s, b_s = sht.map2alm_spin(q, u, rings, lmax)
        e_d, b_d = psht.map2alm_spin_dist(q, u, rings, lmax, mesh8)
        np.testing.assert_allclose(np.asarray(jnp.abs(e_d - e_s)), 0.0,
                                   atol=1e-10)
        np.testing.assert_allclose(np.asarray(jnp.abs(b_d - b_s)), 0.0,
                                   atol=1e-10)


class TestGridSharding:
    """Grid-axis sharding of genuinely large work (parallel/fourier.py):
    the pencil-decomposed distributed FFT, a >=4096^2 masked-spectra
    pipeline sharded over rows, and the reference's row-parallel lensed
    covariance (lensing.py:563-648) sharded over covariance rows — all
    with exact serial parity, exercising BOTH mesh axes simultaneously
    where a batch dimension exists."""

    @pytest.fixture(scope="class")
    def mesh24(self):
        from orphics_tpu.parallel.runtime import get_mesh
        return get_mesh(shape=(2, 4))

    def test_fft2_dist_matches_serial_both_axes(self, mesh24):
        from orphics_tpu.parallel import fourier as pfourier
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 64, 64)).astype(np.float32)
        z = pfourier.fft2_dist(x, mesh24, axis="grid", batch_axis="sims")
        ref = np.fft.fft2(x)
        np.testing.assert_allclose(np.asarray(z), ref, rtol=0, atol=2e-4)
        # inverse closes the loop
        xi = pfourier.ifft2_dist(z, mesh24, axis="grid",
                                 batch_axis="sims")
        np.testing.assert_allclose(np.asarray(xi.real), x, atol=2e-6)

    def test_masked_bandpowers_4096_grid_sharded(self):
        """4096^2 masked-spectra pipeline sharded over the grid axis:
        window -> distributed FFT -> power -> binned bandpowers, one
        shard_map program, vs the identical serial computation. All 8
        devices on 'grid' so the all_to_all and the column-sharded bin
        table really move data (a (ndev,1) mesh would make both
        no-ops and prove nothing)."""
        from orphics_tpu.parallel import fourier as pfourier
        from orphics_tpu.parallel.runtime import get_mesh
        from orphics_tpu import rect_geometry
        from orphics_tpu.ops.windows import get_taper
        mesh8 = get_mesh(shape=(1, 8))
        n = 4096
        geom = rect_geometry(width_arcmin=n * 0.5, px_res_arcmin=0.5)
        rng = np.random.default_rng(1)
        m = rng.standard_normal((n, n)).astype(np.float32)
        taper, _ = get_taper(geom, taper_percent=12.0)
        taper = np.asarray(taper, np.float32)
        edges = np.arange(80, 8000, 400.0)
        ml = geom.modlmap_np()
        dig = np.digitize(ml, edges).astype(np.int32)
        dig[dig == len(edges)] = 0          # overflow -> out of range
        nbins = len(edges) - 1
        norm = float(geom.area) / float(geom.npix) ** 2
        bp = pfourier.masked_bandpowers_dist(m, taper, dig, nbins, norm,
                                             mesh8, axis="grid")
        assert bp.shape == (nbins,)
        # serial reference
        z = np.fft.fft2((m * taper).astype(np.complex64))
        p = (np.abs(z) ** 2).astype(np.float64) * norm
        sums = np.bincount(dig.ravel(), weights=p.ravel(),
                           minlength=nbins + 1)
        cnts = np.bincount(dig.ravel(), minlength=nbins + 1)
        ref = sums[1:] / np.maximum(cnts[1:], 1)
        np.testing.assert_allclose(np.asarray(bp), ref, rtol=2e-4)

    def test_lens_cov_rows_sharded(self, mesh24):
        """Row-sharded lensed covariance over BOTH mesh axes flattened
        (the MPI rank-strided row loop of reference lens_cov) == the
        serial vmapped lens_cov, and the output really is sharded."""
        from orphics_tpu.parallel import fourier as pfourier
        from orphics_tpu import rect_geometry
        from orphics_tpu.models import nfwfit, theory, pixcov
        from orphics_tpu.ops import fourier as F
        geom = rect_geometry(width_arcmin=16 * 2.0, px_res_arcmin=2.0)
        th = theory.default_theory()
        # ncomp=1 -> already (npix, npix)
        ucov = np.asarray(pixcov.scov_from_theory(
            geom, th, lambda l: F.gauss_beam(l, 5.0), ncomp=1), np.float64)
        assert ucov.shape == (geom.npix, geom.npix)
        ay = 0.3 * geom.dy * np.cos(
            np.linspace(0, 2 * np.pi, geom.shape[0]))[:, None] \
            * np.ones(geom.shape)
        ax = 0.3 * geom.dx * np.sin(
            np.linspace(0, 2 * np.pi, geom.shape[1]))[None, :] \
            * np.ones(geom.shape)
        alpha = jnp.asarray(np.stack([ay, ax]))
        kbeam = jnp.asarray(np.asarray(F.gauss_beam(
            geom.modlmap(jnp.float64), 5.0)))
        ref = np.asarray(nfwfit.lens_cov(jnp.asarray(ucov), alpha, geom,
                                         lens_order=3, kbeam=kbeam))
        got = pfourier.lens_cov_dist(jnp.asarray(ucov), alpha, geom,
                                     mesh24, lens_order=3, kbeam=kbeam)
        # genuinely distributed: one row block per device
        assert len(got.sharding.device_set) == 8
        np.testing.assert_allclose(np.asarray(got), ref, atol=1e-10)


class TestInitMultihost:
    """init_multihost: the reference's MPI-or-fake world bootstrap
    (orphics/mpi.py:62-74) on the jax.distributed runtime."""

    ENV = ("JAX_COORDINATOR_ADDRESS",)

    def test_single_process_noop(self, monkeypatch):
        from orphics_tpu.parallel import init_multihost
        for v in self.ENV:
            monkeypatch.delenv(v, raising=False)
        calls = []
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda **kw: calls.append(kw))
        assert init_multihost() == (0, 1)
        assert calls == []           # fakeMpiComm degradation: no init

    def test_coordinator_env_triggers_initialize(self, monkeypatch):
        from orphics_tpu.parallel import init_multihost
        for v in self.ENV:
            monkeypatch.delenv(v, raising=False)
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
        calls = []
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda **kw: calls.append(kw))
        idx, cnt = init_multihost()
        assert len(calls) == 1
        assert (idx, cnt) == (jax.process_index(), jax.process_count())

    def test_idempotent_on_reinit(self, monkeypatch):
        from orphics_tpu.parallel import init_multihost

        def boom(**kw):
            raise RuntimeError("jax.distributed is already initialized")

        for v in self.ENV:
            monkeypatch.delenv(v, raising=False)
        monkeypatch.setattr(jax.distributed, "initialize", boom)
        idx, cnt = init_multihost(coordinator_address="localhost:1234")
        assert (idx, cnt) == (jax.process_index(), jax.process_count())

    def test_real_errors_propagate(self, monkeypatch):
        from orphics_tpu.parallel import init_multihost

        def boom(**kw):
            raise RuntimeError("connection refused")

        monkeypatch.setattr(jax.distributed, "initialize", boom)
        with pytest.raises(RuntimeError, match="connection refused"):
            init_multihost(coordinator_address="localhost:1234")
