"""Minimum-variance lensing-noise curves vs the Planck 2018 release.

Builds the five-estimator N_L^0 matrix (including cross-N0 terms) at a
Planck-like beam/noise with the native QE engine and compares the full
minimum-variance combination 1/sum_ij (N^-1)_ij against the shipped
``planck_2018_mv_nlkk.dat`` curve (the reference-tutorial
``NlGenerator.getNls`` + MV-combination workflow).

Run: python examples/qe_mv_noise.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere

import os
import numpy as np
import jax.numpy as jnp

from orphics_tpu import rect_geometry, io
from orphics_tpu.models import theory, qe

DATA = os.path.join(os.path.dirname(__file__), "..", "orphics_tpu", "data")

_QUICK = __import__("os").environ.get("ORPHICS_TPU_EXAMPLE_QUICK") == "1"
geom = rect_geometry(width_arcmin=(64 if _QUICK else 128) * 8.0, px_res_arcmin=8.0)
th = theory.default_theory()
edges = np.arange(40, 1000, 60.0)
gen = qe.NlGenerator(geom, th, edges, dtype=jnp.float64)
gen.update_noise(beam_arcmin=7.0, noise_t_uk_arcmin=35.0,
                 noise_p_uk_arcmin=55.0, tellmin=100, tellmax=2048,
                 pellmin=100, pellmax=2048, kmin=20, kmax=2100)

pl = io.Plotter(xlabel=r"$L$", ylabel=r"$N_L^{\kappa\kappa}$",
                xscale="log", yscale="log")
for est in ("TT", "TE", "EE", "EB", "TB"):
    cents, nl = gen.get_nl(est)
    pl.add(cents, nl, label=est, alpha=0.6)
cents, mv = gen.get_nl_mv()
_, naive = gen.get_nl_mv(naive=True)
pl.add(cents, mv, color="k", lw=2, label="MV (full cross-N0)")
pl.add(cents, naive, color="k", ls=":", label="MV (naive)")
planck = np.loadtxt(os.path.join(DATA, "planck_2018_mv_nlkk.dat"))
pl.add(planck[:, 0], planck[:, 1], color="r", ls="--",
       label="Planck 2018 release")
pl._ax.set_xlim(30, 1100)
pl.done("qe_mv_noise.png", verbose=True)

sel = (cents > 100) & (cents < 950)
plint = np.interp(cents[sel], planck[:, 0], planck[:, 1])
print("MV / Planck-2018 ratio over L in (100, 950): "
      f"median {np.median(mv[sel] / plint):.2f}")
print(f"full-MV / naive-MV median: {np.median(mv[sel] / naive[sel]):.3f}")
