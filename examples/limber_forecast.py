"""Limber C_l for CMB lensing x galaxies and Knox S/N forecasts.

Reference ``tutorials/Uncertainties on Bandpowers.ipynb`` pattern:
native (CAMB-free) Limber quadrature vmapped on device, then Knox
forecasting with LensForecast.

Run: python examples/limber_forecast.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere

import numpy as np

from orphics_tpu import io
from orphics_tpu.models import cosmology as cosmo, theory

lc = cosmo.LimberCosmology(numz=800)
print("sigma8 =", lc.sigma8())

# a DES-like foreground galaxy sample
zs = np.linspace(0.2, 1.4, 120)
nz = zs ** 2 * np.exp(-(zs / 0.5) ** 1.5)
lc.addNz("g", zs, nz, bias=1.8)
lc.addDeltaNz("s", 1.0)  # a source plane at z=1

ells = np.arange(30, 2000, 10)
lc.generateCls(ells)
clkk = lc.getCl("cmb", "cmb")
clkg = lc.getCl("cmb", "g")
clgg = lc.getCl("g", "g")

# Knox S/N for kappa x galaxies with SO-like lensing noise + shot noise
th = theory.default_theory()
lf = cosmo.LensForecast()
nlkk = np.interp(ells, *np.loadtxt(
    theory.DATA_DIR + "/planck_2018_mv_nlkk.dat", unpack=True, usecols=[0, 1]))
lf.loadKK(ells, clkk, ells, nlkk)
lf.loadGG(ells, clgg, ngal=10.0)  # 10 gal/arcmin^2
lf.loadKG(ells, clkg)
edges = np.arange(40, 1500, 80)
sn, errs = lf.sn(edges, fsky=0.4, specType="kg")
print(f"S/N of C_L^kg (fsky=0.4, Planck-MV kappa noise): {sn:.1f}")

pl = io.Plotter(scheme="CL")
pl.add(ells, clkk, label=r"$C_L^{\kappa\kappa}$")
pl.add(ells, clkg, label=r"$C_L^{\kappa g}$")
pl.add(ells, clgg, label=r"$C_L^{gg}$")
pl.done("limber_forecast.png", verbose=True)
