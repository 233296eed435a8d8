"""Cosmic-shear Limber forecast with Fisher corner plot.

The native ``LimberCosmicShear`` likelihood (reference cobaya
``GenericLimberCosmicShear``, ``cosmology.py:1771``): Knox band
covariance for a delta source plane, detection S/N, and a Fisher
forecast over (As-scale, omch2) rendered as a triangle plot (reference
``stats.py:253`` ``corner_plot``).

Run: python examples/shear_corner.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere

import numpy as np

from orphics_tpu.models.shear import LimberCosmicShear
from orphics_tpu.utils.plot import corner_plot

configs = {
    "LSST-like (ngal=27, fsky=0.4)": dict(zsrc=1.0, ngal_arcmin2=27.0,
                                          fsky=0.4),
    "DES-like (ngal=6, fsky=0.12)": dict(zsrc=0.8, ngal_arcmin2=6.0,
                                         fsky=0.12),
}

param_steps = {"As": (2.15086e-9, 4e-11),
               "omch2": (0.1203058, 0.004)}
fishers = []
for label, cfg in configs.items():
    like = LimberCosmicShear(**cfg)
    print(f"{label}: S/N = {like.sn():.1f}")
    names, F = like.fisher(param_steps)
    errs = np.sqrt(np.diag(np.linalg.inv(F)))
    for n, e in zip(names, errs):
        print(f"  sigma({n}) = {e:.3e}")
    fishers.append(F)

corner_plot(fishers, list(configs.keys()), list(param_steps.keys()),
            fid_dict={k: v[0] for k, v in param_steps.items()},
            latex_dict={"As": r"$A_s$",
                        "omch2": r"$\Omega_c h^2$"},
            save_file="shear_corner.png")
print("saved shear_corner.png")
