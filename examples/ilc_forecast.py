"""Multi-frequency harmonic ILC with tSZ/CMB deprojection over 6 bands.

Bench config 4: build the beam-deconvolved multi-frequency covariance
(CMB + tSZ + CIB + kSZ + radio + noise), invert per ell, and form
standard and constrained ILC noise curves.

Run: python examples/ilc_forecast.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere

import numpy as np
import jax.numpy as jnp

from orphics_tpu import io
from orphics_tpu.models import theory, ilc, foregrounds as fg
from orphics_tpu.ops.fourier import gauss_beam
from orphics_tpu.geometry import arcmin

freqs = np.array([39.0, 93.0, 145.0, 225.0, 280.0, 350.0])
beams = np.array([5.1, 2.2, 1.4, 1.0, 0.9, 0.8])
noises = np.array([36.0, 8.0, 10.0, 22.0, 54.0, 100.0])
fluxes = np.array([10.0, 7.0, 10.0, 10.0, 10.0, 10.0])

_QUICK = __import__("os").environ.get("ORPHICS_TPU_EXAMPLE_QUICK") == "1"
ellmax = 2000 if _QUICK else 8000
ells = np.arange(2, ellmax)
th = theory.default_theory()
cltt = np.asarray(th.lCl("TT", ells))
kbeams = [np.asarray(gauss_beam(ells, b)) for b in beams]
n2 = (noises * arcmin) ** 2

cinv, cov = ilc.ilc_cinv(ells, cltt, kbeams, freqs, n2,
                         components=("tsz", "cibc", "cibp", "ksz", "radps"),
                         fdict=fg.fg_dict(fluxes, freqs))

# standard CMB ILC and tSZ-deprojected constrained ILC noise
a_cmb = jnp.ones(len(freqs))
a_tsz = jnp.asarray(fg.g_tsz(freqs))
n_ilc = np.asarray(ilc.silc_noise(cinv, a_cmb)) - cltt
n_cilc = np.asarray(ilc.cilc_noise(cinv, a_cmb, a_tsz)) - cltt

print("ILC noise at l=3000:", np.interp(3000, ells, n_ilc))
print("tSZ-deproj ILC noise at l=3000:", np.interp(3000, ells, n_cilc))
print("deprojection penalty:", np.interp(3000, ells, n_cilc)
      / np.interp(3000, ells, n_ilc))

pl = io.Plotter(scheme="Dell", ylabel=r"$D_\ell$ [$\mu K^2$]")
pl.add(ells, cltt, color="k", label="lensed CMB TT")
pl.add(ells, np.abs(n_ilc), label="ILC noise")
pl.add(ells, np.abs(n_cilc), ls="--", label="tSZ-deprojected ILC noise")
ells_so, nells_so = fg.get_official_ilc_noise("so")
pl.add(ells_so, nells_so, ls=":", label="SO official ILC")
pl.done("ilc_forecast.png", verbose=True)
