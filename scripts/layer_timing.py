"""Per-layer GPU timings behind PERF.md's bring-up numbers.

Run from the repository root on a machine with a GPU:

    python scripts/layer_timing.py > layers.jsonl

One JSON line per measurement, each naming the device and the card's
power limit:

  * ``fft``: cuFFT R2C (``jnp.fft.rfft2``) at 2048^2 x 192, with its share
    of the HBM bandwidth roofline;
  * ``bin``: each binning strategy (``triton``, ``segment``, ``rowcum``)
    alone at 2048^2 x 192 on the half plane, and inside the config-1 step
    (``FastCl.sim_bandpowers`` at 2048^2, batch 192);
  * ``lens``: the B-spline displacement gather at 512^2 x 64, order 5;
  * ``sht``: the lmax-2047 roundtrip of 1 and 4 maps, error and time with
    the contraction precision at ``DEFAULT``, ``HIGH`` and ``HIGHEST``,
    with the matrix products of each compiled program (cuBLAS calls and
    XLA ``dot``s by operand precision);
  * ``sht_dist``: ``parallel.sht.map2alm_dist`` at lmax 1023 on a ring
    mesh of every device, 1 and 4 maps, at each precision against the
    serial transform at ``HIGHEST``.

``--hlo-dir DIR`` writes each SHT program's compiled HLO text there.
The FFT's bandwidth share is host-timed: bytes over the host-clock
median, not a kernel time from a trace.

Times are the median of ``--reps`` runs that each end in
``jax.block_until_ready``, after one compile-and-warm-up run.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# Published H100 SXM HBM3 bandwidth (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def _median_time(fn, args, reps):
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _matmul_summary(hlo):
    """Count a compiled program's matrix products by kind, result type,
    operand precision and algorithm: library calls (``__cublas...``) and
    XLA's own ``dot`` instructions."""
    counts = {}
    for line in hlo.splitlines():
        call = re.search(r'custom_call_target="(__cublas[^"]*)"', line)
        if call:
            prec = re.search(r'"operand_precision":\[([^\]]*)\]', line)
            alg = re.search(r'"algorithm":"(\w+)"', line)
            kind = call.group(1)
        elif re.search(r"\bdot\(", line):
            prec = re.search(r"operand_precision=\{([^}]*)\}", line)
            alg = re.search(r"algorithm=(\w+)", line)
            kind = "dot"
        else:
            continue
        ty = re.search(r"=\s*\(?(\w+)\[", line)
        key = (f"{kind} {ty.group(1) if ty else '?'} "
               f"precision={prec.group(1).replace(chr(34), '') if prec else 'DEFAULT'} "
               f"algorithm={alg.group(1) if alg else 'unset'}")
        counts[key] = counts.get(key, 0) + 1
    return counts


def main():
    import jax
    import jax.numpy as jnp
    from orphics_tpu.utils import compile_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--layers", default="fft,bin,lens,sht,sht_dist")
    ap.add_argument("--hlo-dir", default=None)
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"layer_timing: needs a GPU, found {dev.platform}")
    compile_cache.enable(ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    base = {"platform": dev.platform, "device_kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}
    failed = []

    def emit(**kw):
        print(json.dumps({**base, **kw}), flush=True)

    def run(name, fn):
        try:
            fn()
        except Exception as e:  # report and go on to the next layer
            failed.append(name)
            emit(layer=name, error=f"{type(e).__name__}: {e}"[:2000])

    from orphics_tpu import rect_geometry
    from orphics_tpu.models import theory
    th = theory.default_theory()
    n, batch = 2048, 192
    geom = rect_geometry(width_arcmin=n * 0.5, px_res_arcmin=0.5)
    nxr = n // 2 + 1
    edges = np.arange(80, 8000, 80.0)

    def fft():
        x = jax.random.normal(jax.random.PRNGKey(0), (batch, n, n),
                              jnp.float32)
        f = jax.jit(jnp.fft.rfft2)
        t = _median_time(f, (x,), args.reps)
        nbytes = batch * n * n * 4 + batch * n * nxr * 8
        peak = HBM_BYTES_PER_S.get(dev.device_kind)
        emit(layer="fft", op="rfft2", shape=[batch, n, n], seconds=t,
             bytes=nbytes, host_timed_roofline_share=(
                 nbytes / peak / t if peak else None))

    def binning():
        from orphics_tpu.ops.binning import RfftBin2D
        from orphics_tpu.maps import FastCl
        ells = np.arange(th.lpad + 1)
        cltt = np.asarray(th.lCl("TT", ells))
        data = jax.random.exponential(jax.random.PRNGKey(1),
                                      (batch, n, nxr), jnp.float32)
        ref = None
        for strat in ("triton", "segment", "rowcum"):
            b = RfftBin2D(geom, edges, strategy=strat)
            f = jax.jit(b.sum)
            out = np.asarray(f(data), np.float64)
            if ref is None:
                host = np.asarray(data).reshape(batch, -1)
                ref = np.stack([np.bincount(
                    b._dig, weights=r.astype(np.float64),
                    minlength=len(edges) + 1)[1:-1] for r in host])
            live = ref != 0
            err = float(np.max(np.abs(out - ref)[live] / ref[live]))
            t = _median_time(f, (data,), args.reps)
            emit(layer="bin", strategy=strat, shape=[batch, n, nxr],
                 seconds=t, bytes=batch * n * nxr * 4, max_rel_err=err)
            fc = FastCl(geom, ells, cltt, bin_edges=edges, strategy=strat)
            step = jax.jit(lambda k, fc=fc: fc.sim_bandpowers(k, batch))
            t = _median_time(step, (jax.random.PRNGKey(2),), args.reps)
            emit(layer="config1_step", strategy=strat, batch=batch,
                 seconds=t, pipelines_per_s=batch / t)

    def lens():
        from orphics_tpu.models.lensing import _eval_spline_coeffs
        g = rect_geometry(width_arcmin=512 * 2.0, px_res_arcmin=2.0)
        k1, k2 = jax.random.split(jax.random.PRNGKey(3))
        coeffs = jax.random.normal(k1, (64,) + g.shape, jnp.float32)
        alpha = 7e-4 * jax.random.normal(k2, (64, 2) + g.shape,
                                         jnp.float32)
        f = jax.jit(jax.vmap(lambda c, a: _eval_spline_coeffs(c, a, g, 5)))
        t = _median_time(f, (coeffs, alpha), args.reps)
        emit(layer="lens", op="spline_gather_order5", shape=[64, 512, 512],
             seconds=t)

    precisions = (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGH,
                  jax.lax.Precision.HIGHEST)

    def compile_at(prec, fn, fn_args, tag):
        """Compile ``fn`` with the SHT contractions at ``prec``; return the
        executable and its matrix-product summary."""
        from orphics_tpu.ops import sht
        from orphics_tpu.parallel import sht as psht
        default = sht._EPREC
        sht._EPREC = prec
        # the precision is read at trace time: drop every cached trace
        psht._map2alm_dist_fn.cache_clear()
        jax.clear_caches()
        try:
            compiled = jax.jit(fn).lower(*fn_args).compile()
        finally:
            sht._EPREC = default
            psht._map2alm_dist_fn.cache_clear()
            jax.clear_caches()
        hlo = compiled.as_text()
        if args.hlo_dir:
            os.makedirs(args.hlo_dir, exist_ok=True)
            with open(os.path.join(args.hlo_dir, f"{tag}_{prec.name}.hlo"),
                      "w") as f:
                f.write(hlo)
        return compiled, _matmul_summary(hlo)

    def sht_precision():
        from orphics_tpu.ops import sht
        from chip_smoke import _unit_alm
        lmax = 2047
        rings = sht.gauss_legendre_rings(lmax)
        tab = sht._tables_for(rings, lmax, (0,), jnp.float32)

        def rt(a, t):
            m = sht._alm2map_impl(a, t, rings=rings, lmax=lmax)
            return sht._map2alm_impl(m, t, rings=rings, lmax=lmax)

        for nmaps in (1, 4):
            keys = jax.random.split(jax.random.PRNGKey(4), nmaps)
            a0 = jax.vmap(lambda k: _unit_alm(k, lmax))(keys)
            if nmaps == 1:
                a0 = a0[0]
            for prec in precisions:
                f, mm = compile_at(prec, rt, (a0, tab),
                                   f"sht_rt_lmax{lmax}_n{nmaps}")
                err = float(jnp.max(jnp.abs(f(a0, tab) - a0)))
                t = _median_time(f, (a0, tab), max(3, args.reps // 3))
                emit(layer="sht", op="roundtrip", lmax=lmax, maps=nmaps,
                     precision=prec.name, seconds=t, max_abs_err=err,
                     matmuls=mm)

    def sht_dist():
        from jax.sharding import Mesh
        from orphics_tpu.ops import sht
        from orphics_tpu.parallel import sht as psht
        lmax = 1023
        rings = sht.gauss_legendre_rings(lmax)
        mesh = Mesh(np.array(jax.devices()), ("rings",))
        for nmaps in (1, 4):
            shape = ((nmaps,) if nmaps > 1 else ()) + rings.shape
            maps = jax.random.normal(jax.random.PRNGKey(5), shape,
                                     jnp.float32)
            ref = sht.map2alm(maps, rings, lmax)
            scale = float(jnp.max(jnp.abs(ref)))
            for prec in precisions:
                f, mm = compile_at(
                    prec, lambda x: psht.map2alm_dist(x, rings, lmax, mesh,
                                                      axis="rings"),
                    (maps,), f"map2alm_dist_lmax{lmax}_n{nmaps}")
                err = float(jnp.max(jnp.abs(f(maps) - ref))) / scale
                emit(layer="sht_dist", op="map2alm_dist", lmax=lmax,
                     maps=nmaps, devices=mesh.size, precision=prec.name,
                     err_over_max=err, matmuls=mm)

    layers = {"fft": fft, "bin": binning, "lens": lens, "sht": sht_precision,
              "sht_dist": sht_dist}
    for name in args.layers.split(","):
        run(name, layers[name])
    if failed:
        sys.exit(f"layer_timing: failed layers {failed}")


if __name__ == "__main__":
    main()
