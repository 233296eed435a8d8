"""Smoke test of orphics_tpu's main paths on NVIDIA GPUs.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py              # one GPU: phases (a)-(c)
    python chip_smoke.py --multi 4    # four GPUs: the mesh paths only

Phases, each at the size the bench uses and each checked against a plain
reference:

  (a) flat sky: ``maps.FastCl`` at 2048^2, 0.5' pixels — bandpowers of 4
      maps against float64 numpy, the binning strategy in use against a
      float64 ``np.bincount`` at 2048^2 x 192, and the mean of 64 GRF
      sims against the binned 2D theory;
  (b) lensing: the flagship ``__graft_entry__.entry()`` step at 512^2,
      ``LensedQEPipeline.step`` on the GPU against the same key on the
      CPU, and the recon x input / input ratio at batch 64;
  (c) curved sky: SHT roundtrips at lmax 2047 (spin 0) and 1023
      (spin 2), and the masked-Cl Monte Carlo at lmax 1023, batch 8.

``--multi N`` runs only the device-mesh paths over N GPUs (sims-axis
ensemble of the flagship step, pencil FFT and masked bandpowers at
4096^2, ring-distributed map2alm of 4 maps at lmax 1023), each against
one GPU.

Every step prints its compile time, one steady-state time, XLA's memory
analysis and the device's peak bytes in use. Any failed check exits
non-zero. The last line of stdout is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


class CheckFailed(AssertionError):
    pass


def check(name, value, limit, ok):
    """Print one tolerance check; raise if it failed."""
    print(f"check {name}: {value:.3e} (limit {limit:.3e}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise CheckFailed(f"{name}: {value} vs limit {limit}")


def require_gpu():
    """The first JAX device, which must be a GPU (exits otherwise)."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX default device is "
              f"{dev.platform}); nothing was run", file=sys.stderr)
        sys.exit(1)
    return dev


def card_info():
    """The cards' names and power limits as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip()


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def measure(name, fn, *args):
    """AOT-compile ``fn`` for ``args``, run it twice, print compile time,
    steady-state time, memory analysis and peak device bytes; return the
    output of the second run."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(lambda *a: fn(*a)).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    t_run = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    mem_txt = "n/a" if mem is None else (
        f"args={mem.argument_size_in_bytes} out={mem.output_size_in_bytes} "
        f"temp={mem.temp_size_in_bytes}")
    print(f"step {name}: compile {t_compile:.3f} s, steady {t_run:.6f} s, "
          f"memory[{mem_txt}], peak_bytes_in_use={_peak_bytes()}",
          flush=True)
    return out


def _default_theory():
    from orphics_tpu.models import theory
    return theory.default_theory()


# ---------------------------------------------------------------------------
# Phase (a): flat-sky GRF -> FFT -> binned bandpowers
# ---------------------------------------------------------------------------

def _np_bandpowers(maps, geom, edges):
    """float64 numpy reference: rfft2 -> |.|^2 -> bincount with the
    Hermitian multiplicity of each half-plane column."""
    ml = geom.modlmap_np()
    nxr = geom.nx // 2 + 1
    dig_full = np.digitize(ml.ravel(), edges, right=True)
    nb = len(edges) - 1
    counts = np.bincount(dig_full, minlength=nb + 2)[1:-1]
    dig = np.digitize(ml[:, :nxr].ravel(), edges, right=True)
    mult = np.full((geom.ny, nxr), 2.0)
    mult[:, 0] = 1.0
    if geom.nx % 2 == 0:
        mult[:, -1] = 1.0
    norm = float(geom.area) / float(geom.npix) ** 2
    out = []
    for m in maps:
        p = np.abs(np.fft.rfft2(np.asarray(m, np.float64))) ** 2 * norm
        s = np.bincount(dig, weights=(p * mult).ravel(), minlength=nb + 2)
        out.append(s[1:-1] / np.maximum(counts, 1))
    return np.stack(out)


def phase_flat(n=2048, px=0.5, nmaps=4, nbin_maps=192, nsims=64,
               seed=0, lrange=(500.0, 5000.0)):
    """Phase (a). Returns the checked numbers."""
    import jax
    import jax.numpy as jnp
    from orphics_tpu import rect_geometry
    from orphics_tpu.maps import FastCl

    geom = rect_geometry(width_arcmin=n * px, px_res_arcmin=px)
    th = _default_theory()
    ells = np.arange(th.lpad + 1)
    cltt = np.asarray(th.lCl("TT", ells))
    edges = np.arange(80, 8000, 80.0)
    fc = FastCl(geom, ells, cltt, bin_edges=edges)
    print(f"phase a: {n}x{n}, binning strategy {fc.binner.strategy}",
          flush=True)
    rng = np.random.default_rng(seed)

    maps = rng.standard_normal((nmaps,) + geom.shape).astype(np.float32)
    got = np.asarray(measure("map_bandpowers", fc.map_bandpowers,
                             jnp.asarray(maps)), np.float64)
    ref = _np_bandpowers(maps, geom, edges)
    live = ref != 0
    err_bp = float(np.max(np.abs(got - ref)[live] / np.abs(ref[live])))
    check("map_bandpowers per-bin rel err vs float64", err_bp, 1e-5,
          err_bp <= 1e-5)

    # the strategy in use vs float64 bincount, at the config-1 batch
    nxr = geom.nx // 2 + 1
    data = measure("bin_data", lambda k: jax.random.exponential(
        k, (nbin_maps, geom.ny, nxr), jnp.float32),
        jax.random.PRNGKey(seed + 1))
    sums = np.asarray(measure("binner_sum", fc.binner.sum, data),
                      np.float64)
    host = np.asarray(data).reshape(nbin_maps, -1)
    dig = fc.binner._dig
    nb = len(edges) - 1
    ref_s = np.stack([np.bincount(dig, weights=row.astype(np.float64),
                                  minlength=nb + 2)[1:-1] for row in host])
    live = ref_s != 0
    err_bin = float(np.max(np.abs(sums - ref_s)[live] / ref_s[live]))
    check(f"binning ({fc.binner.strategy}) rel err vs float64 bincount",
          err_bin, 2e-6, err_bin <= 2e-6)
    del data, host

    bps = np.asarray(measure(
        "sim_bandpowers", lambda k: fc.sim_bandpowers(k, nsims),
        jax.random.PRNGKey(seed + 2)), np.float64)
    c2d = np.interp(geom.modlmap_np()[:, :nxr], ells, cltt, left=0,
                    right=0)
    _, th_b = fc.binner.bin(jnp.asarray(c2d, jnp.float32))
    th_b = np.asarray(th_b, np.float64)
    cents = np.asarray(fc.centers)
    sel = (cents > lrange[0]) & (cents < lrange[1])
    ratio = float(np.mean(bps.mean(axis=0)[sel] / th_b[sel]))
    check("sim_bandpowers mean / binned theory - 1", abs(ratio - 1.0),
          0.01, abs(ratio - 1.0) < 0.01)
    return {"map_bp": err_bp, "bin": err_bin, "sim_ratio": ratio}


# ---------------------------------------------------------------------------
# Phase (b): lensing Monte Carlo
# ---------------------------------------------------------------------------

def phase_lensing(n=512, px=2.0, batch=64, cmp_batch=2, seed=0,
                  run_entry=True):
    """Phase (b). Returns the checked numbers."""
    import jax
    from orphics_tpu import rect_geometry
    from orphics_tpu.models import lenspipe

    out = {}
    if run_entry:
        sys.path.insert(0, ROOT)
        import __graft_entry__ as ge
        fn, args = ge.entry()
        res = np.asarray(measure("entry", fn, *args))
        finite = bool(np.all(np.isfinite(res)))
        print(f"entry: shape {res.shape}, finite {finite}", flush=True)
        if not finite:
            raise CheckFailed("entry() produced non-finite spectra")

    geom = rect_geometry(width_arcmin=n * px, px_res_arcmin=px)
    th = _default_theory()
    key = jax.random.PRNGKey(seed)
    pipe = lenspipe.LensedQEPipeline(geom, th, lens_order=5)
    dev_out = np.asarray(measure(
        f"lenspipe_b{cmp_batch}", lambda k: pipe.step(k, cmp_batch), key))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        pipe_cpu = lenspipe.LensedQEPipeline(geom, _default_theory(),
                                             lens_order=5)
        cpu_out = np.asarray(pipe_cpu.step(jax.device_put(key, cpu),
                                           cmp_batch))
    worst = 0.0
    for b in range(cmp_batch):
        for s in range(3):
            scale = np.max(np.abs(cpu_out[b, s]))
            worst = max(worst, float(
                np.max(np.abs(dev_out[b, s] - cpu_out[b, s])) / scale))
    check("lenspipe device vs CPU max-abs / max", worst, 1e-4,
          worst <= 1e-4)
    out["device_vs_cpu"] = worst

    spec = np.asarray(measure(f"lenspipe_b{batch}",
                              lambda k: pipe.step(k, batch),
                              jax.random.PRNGKey(seed + 1)), np.float64)
    cross, auto = spec[:, 0], spec[:, 1]
    ratio = cross.mean(axis=0) / auto.mean(axis=0)
    err = cross.std(axis=0, ddof=1) / np.sqrt(batch) / auto.mean(axis=0)
    excess = float(np.max(np.abs(ratio - 1) - (5 * err + 0.1)))
    check("lenspipe max(|cross/auto - 1| - (5 err + 0.1))", excess, 0.0,
          excess < 0.0)
    out["ratio_excess"] = excess
    return out


# ---------------------------------------------------------------------------
# Phase (c): curved-sky SHTs
# ---------------------------------------------------------------------------

def _unit_alm(key, lmax):
    """Unit-variance complex64 alm up to ``lmax`` (real at m = 0)."""
    import jax
    import jax.numpy as jnp
    nalm = (lmax + 1) * (lmax + 2) // 2
    kr, ki = jax.random.split(key)
    a = (jax.random.normal(kr, (nalm,), jnp.float32)
         + 1j * jax.random.normal(ki, (nalm,), jnp.float32))
    # m = 0 modes of a real field are real
    return a.at[..., : lmax + 1].set(
        jnp.real(a[..., : lmax + 1]).astype(jnp.complex64))


def phase_curved(lmax=2047, lmax_spin=1023, lmax_mc=1023, mc_batch=8,
                 seed=0, tol=1e-5):
    """Phase (c). Returns the checked numbers."""
    import jax
    import jax.numpy as jnp
    from orphics_tpu.ops import sht
    from orphics_tpu.ops import alm as almops

    out = {}
    rings = sht.gauss_legendre_rings(lmax)
    tab = sht._tables_for(rings, lmax, (0,), jnp.float32)
    a0 = _unit_alm(jax.random.PRNGKey(seed), lmax)

    def roundtrip(a, t):
        m = sht._alm2map_impl(a, t, rings=rings, lmax=lmax)
        return sht._map2alm_impl(m, t, rings=rings, lmax=lmax)

    a1 = measure(f"sht_roundtrip_lmax{lmax}", roundtrip, a0, tab)
    err = float(jnp.max(jnp.abs(a1 - a0)))
    check(f"spin-0 roundtrip max-abs err, lmax {lmax}", err, tol,
          err <= tol)
    out["rt0"] = err

    rings2 = sht.gauss_legendre_rings(lmax_spin)
    tab2 = sht._tables_for(rings2, lmax_spin, (-2, 2), jnp.float32)
    ke, kb = jax.random.split(jax.random.PRNGKey(seed + 1))
    e0 = _unit_alm(ke, lmax_spin).at[: 2].set(0)
    b0 = _unit_alm(kb, lmax_spin).at[: 2].set(0)
    # spin-2 fields carry no l < 2 modes
    lmask = jnp.asarray(almops.lm_indices(lmax_spin)[0] >= 2)
    e0, b0 = e0 * lmask, b0 * lmask

    def roundtrip_spin(e, b, t):
        q, u = sht._alm2map_spin_impl(e, b, t, rings=rings2,
                                      lmax=lmax_spin, spin=2)
        return sht._map2alm_spin_impl(q, u, t, rings=rings2,
                                      lmax=lmax_spin, spin=2)

    e1, b1 = measure(f"sht_spin2_roundtrip_lmax{lmax_spin}",
                     roundtrip_spin, e0, b0, tab2)
    err2 = float(max(jnp.max(jnp.abs(e1 - e0)), jnp.max(jnp.abs(b1 - b0))))
    check(f"spin-2 roundtrip max-abs err, lmax {lmax_spin}", err2, tol,
          err2 <= tol)
    out["rt2"] = err2

    ratio = _masked_cl_mc(lmax_mc, mc_batch, seed + 2)
    check("masked-Cl MC |mean ratio - 1|", abs(ratio - 1.0), 0.2,
          abs(ratio - 1.0) < 0.2)
    out["mc_ratio"] = ratio
    return out


def _masked_cl_mc(lmax, batch, seed):
    """Config 8: synalm + beam -> alm2map -> galactic mask -> map2alm ->
    w2-debiased Cls; returns the mean ratio to the beamed theory over
    100 < l < lmax/2."""
    import jax
    import jax.numpy as jnp
    from orphics_tpu.ops import sht
    from orphics_tpu.ops import alm as almops
    from orphics_tpu.models import curved

    rings = sht.gauss_legendre_rings(lmax)
    tab = sht._tables_for(rings, lmax, (0,), jnp.float32)
    th = _default_theory()
    ells = np.arange(lmax + 1)
    cltt = np.asarray(th.lCl("TT", ells))
    sig = np.deg2rad(10.0 / 60.0) / np.sqrt(8.0 * np.log(2.0))
    bl = np.exp(-0.5 * ells * (ells + 1.0) * sig * sig)
    mask = jnp.asarray(np.asarray(curved.galactic_mask_rings(
        rings, np.deg2rad(76.0), np.deg2rad(104.0), coords="equ")),
        jnp.float32)
    w2 = float(curved.wfactor(2, mask, rings))
    cl_j = jnp.asarray(cltt, jnp.float32)
    bl_j = jnp.asarray(bl, jnp.float32)

    def step(key, t):
        keys = jax.random.split(key, batch)
        alms = jax.vmap(lambda k: almops.synalm(k, cl_j, lmax=lmax))(keys)
        m = sht._alm2map_impl(almops.almxfl(alms, bl_j), t, rings=rings,
                              lmax=lmax)
        a2 = sht._map2alm_impl(m * mask, t, rings=rings, lmax=lmax)
        return jax.vmap(almops.alm2cl)(a2) / w2

    cls = np.asarray(measure(f"masked_cl_mc_lmax{lmax}_b{batch}", step,
                             jax.random.PRNGKey(seed), tab))
    sel = (ells > 100) & (ells < lmax // 2)
    return float(np.mean(cls.mean(0)[sel] / (cltt * bl ** 2)[sel]))


# ---------------------------------------------------------------------------
# --multi N: the device-mesh paths
# ---------------------------------------------------------------------------

def phase_multi(ndev=4, nsims=16, n_fft=4096, lmax=1023, nmaps=4, seed=0):
    """Mesh paths over ``ndev`` devices, each against one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from orphics_tpu import rect_geometry
    from orphics_tpu.parallel import ensemble_stats
    from orphics_tpu.parallel import fourier as pfourier
    from orphics_tpu.parallel import sht as psht
    from orphics_tpu.ops import sht
    from orphics_tpu.ops.windows import get_taper

    devices = jax.devices()
    if len(devices) < ndev:
        raise CheckFailed(f"--multi {ndev}: only {len(devices)} devices")
    devices = devices[:ndev]
    out = {}

    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    step, _ = ge.entry()

    def sim(key):
        o = step(key)
        return {"cross": o[0], "auto_in": o[1], "auto_rec": o[2]}

    key = jax.random.PRNGKey(seed)
    mesh4 = Mesh(np.array(devices), ("sims",))
    mesh1 = Mesh(np.array(devices[:1]), ("sims",))
    t0 = time.perf_counter()
    st4 = ensemble_stats(sim, nsims, key=key, mesh=mesh4, do_cov=False)
    m4 = {k: np.asarray(jax.block_until_ready(v.mean()))
          for k, v in st4.items()}
    print(f"step ensemble_{ndev}dev: first call {time.perf_counter() - t0:.3f} s",
          flush=True)
    st1 = ensemble_stats(sim, nsims, key=key, mesh=mesh1, do_cov=False)
    worst = 0.0
    for k, v in st1.items():
        ref = np.asarray(v.mean())
        worst = max(worst, float(np.max(np.abs(m4[k] - ref))
                                 / np.max(np.abs(ref))))
    check(f"ensemble_stats {ndev} devices vs 1, max-abs / max", worst,
          1e-4, worst <= 1e-4)
    out["ensemble"] = worst

    grid = Mesh(np.array(devices).reshape(1, ndev), ("sims", "grid"))
    geom = rect_geometry(width_arcmin=n_fft * 0.5, px_res_arcmin=0.5)
    m = jax.random.normal(jax.random.PRNGKey(seed + 1), geom.shape,
                          jnp.float32)
    z = measure(f"fft2_dist_{n_fft}", lambda x: pfourier.fft2_dist(
        x, grid, axis="grid"), m)
    zref = jnp.fft.fft2(m)
    err = float(jnp.max(jnp.abs(z - zref)) / jnp.max(jnp.abs(zref)))
    check(f"fft2_dist {n_fft}^2 vs jnp.fft.fft2, max-abs / max", err,
          1e-5, err <= 1e-5)
    out["fft2"] = err

    taper = jnp.asarray(get_taper(geom, taper_percent=12.0)[0],
                        jnp.float32)
    edges = np.arange(80, 8000, 80.0)
    dig = np.digitize(geom.modlmap_np(), edges).astype(np.int32)
    dig[dig == len(edges)] = 0
    nbins = len(edges) - 1
    norm = float(geom.area) / float(geom.npix) ** 2
    bp = np.asarray(measure(
        f"masked_bandpowers_dist_{n_fft}",
        lambda x, w: pfourier.masked_bandpowers_dist(
            x, w, jnp.asarray(dig), nbins, norm, grid, axis="grid"),
        m, taper), np.float64)
    ps = np.abs(np.asarray(jnp.fft.fft2(m * taper))) ** 2 * norm
    sums = np.bincount(dig.ravel(), weights=ps.ravel().astype(np.float64),
                       minlength=nbins + 1)
    cnts = np.bincount(dig.ravel(), minlength=nbins + 1)
    ref_bp = sums[1:] / np.maximum(cnts[1:], 1)
    live = cnts[1:] > 0
    err = float(np.max(np.abs(bp - ref_bp)[live] / np.abs(ref_bp[live])))
    check(f"masked_bandpowers_dist {n_fft}^2 vs single device, rel", err,
          1e-4, err <= 1e-4)
    out["masked_bp"] = err

    rings = sht.gauss_legendre_rings(lmax)
    ring_mesh = Mesh(np.array(devices), ("rings",))
    # several maps: one map's contraction is a matrix-vector product that
    # XLA fuses in plain fp32 whatever the precision asked for; a batch
    # makes it a cuBLAS GEMM, where the precision decides TF32 or not
    maps = jax.random.normal(jax.random.PRNGKey(seed + 2),
                             (nmaps,) + rings.shape, jnp.float32)
    a_dist = measure(f"map2alm_dist_lmax{lmax}",
                     lambda x: psht.map2alm_dist(x, rings, lmax, ring_mesh,
                                                 axis="rings"), maps)
    a_ser = sht.map2alm(maps, rings, lmax)
    err = float(jnp.max(jnp.abs(a_dist - a_ser)) / jnp.max(jnp.abs(a_ser)))
    # between the HIGHEST reading (5.3e-5 on one H100) and the TF32 one
    # (3.2e-4 at HIGH or DEFAULT), PERF.md
    check(f"map2alm_dist lmax {lmax}, {nmaps} maps vs serial, "
          f"max-abs / max", err, 1.5e-4, err <= 1.5e-4)
    out["map2alm"] = err
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", type=int, default=0, metavar="N",
                    help="run only the device-mesh paths over N GPUs")
    args = ap.parse_args(argv)

    dev = require_gpu()
    import jax
    from orphics_tpu.utils import compile_cache
    compile_cache.enable(ROOT)
    print(card_info(), flush=True)
    print(f"jax {jax.__version__}, devices: {len(jax.devices())} x "
          f"{dev.device_kind}", flush=True)
    t0 = time.perf_counter()
    try:
        if args.multi:
            phase_multi(args.multi)
        else:
            phase_flat()
            phase_lensing()
            phase_curved()
    except CheckFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
