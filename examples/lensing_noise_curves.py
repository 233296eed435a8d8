"""N_L^0 lensing reconstruction noise curves for instrument configs,
compared against the Planck 2018 MV N_L^kk product.

Reference ``tutorials/Lensing-noise-curves.ipynb`` pattern with the
native quadratic-estimator normalization integrals (all FFTs, jitted).

Run: python examples/lensing_noise_curves.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere

import numpy as np

from orphics_tpu import maps, io
from orphics_tpu.models import theory, qe
from orphics_tpu.interfaces import PlanckLensing

_QUICK = __import__("os").environ.get("ORPHICS_TPU_EXAMPLE_QUICK") == "1"
geom = maps.rect_geometry(width_deg=5.0 if _QUICK else 10.0,
                          px_res_arcmin=3.0 if _QUICK else 1.5)
th = theory.default_theory()
edges = np.arange(40, 2000, 60.0)
nlg = qe.NlGenerator(geom, th, edges)

configs = {
    "Planck-like (7', 30uK')": dict(beam_arcmin=7.0, noise_t_uk_arcmin=30.0,
                                    tellmax=2500, pellmax=2500),
    "SO-like (1.4', 6uK')": dict(beam_arcmin=1.4, noise_t_uk_arcmin=6.0,
                                 tellmax=3000, pellmax=5000),
    "S4-like (1', 1uK')": dict(beam_arcmin=1.0, noise_t_uk_arcmin=1.0,
                               tellmax=3000, pellmax=5000),
}

pl = io.Plotter(scheme="CL", ylabel=r"$N_L^{\kappa\kappa}$")
ells = np.arange(2, 2000)
pl.add(ells, np.asarray(th.gCl("kk", ells)), color="k", label=r"$C_L^{\kappa\kappa}$")

for label, cfg in configs.items():
    nlg.update_noise(**cfg)
    cents, nl_tt = nlg.get_nl("TT")
    cents, nl_mv = nlg.get_nl_mv(("TT", "TE", "EE", "EB"))
    print(f"{label}: N0_TT(L~100) = {np.interp(100, cents, nl_tt):.3e}")
    pl.add(cents, nl_tt, label=label + " TT")
    pl.add(cents, nl_mv, ls="--", label=label + " MV")

pells, pnl = PlanckLensing().get_nlkk()
pl.add(pells[pells < 2000], pnl[pells < 2000], ls=":",
       label="Planck 2018 MV (official)")
pl.done("lensing_noise_curves.png", verbose=True)
