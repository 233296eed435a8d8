"""RSD k-mode Fisher forecast: joint galaxy-density + radial-velocity
constraints vs galaxy-only, from the linear Kaiser spectra.

Drives the native ``models/rsd.py`` surface (the reference ships this
machinery as broken drafts — ``cosmology.py:1436`` ``kmode_derivatives``
is ``pass`` and ``kmode_fisher``/``Pgg_Pvv_Pgv`` reference undefined
locals; here they are implemented and working).

Run: python examples/rsd_kmode_fisher.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere

import numpy as np

from orphics_tpu.models import rsd
from orphics_tpu.models.cosmology import Cosmology, defaultCosmology


def main():
    z = 0.55                      # BOSS CMASS-like slab
    volume_mpc3 = 4.0e9           # ~4 (Gpc)^3 comoving
    nbar = 3e-4                   # galaxies / Mpc^3
    sigma_v = 1.2e-6              # velocity-tracer noise (dimensionless v/c)

    ks = np.geomspace(5e-3, 0.15, 48)
    mus = np.linspace(0.0, 1.0, 21)

    fid = {k: defaultCosmology[k] for k in ("omch2", "ombh2", "H0", "ns")}
    steps = {"omch2": 0.002, "ombh2": 0.0004, "H0": 0.5, "ns": 0.01,
             "bg": 0.02}
    params = ["omch2", "H0", "bg"]
    bg = 2.0

    dPgg, dPgv, dPvv = rsd.kmode_derivatives(
        ks, mus, params, dict(fid, bg=bg), steps, z, bg=bg)
    fPgg, fPgv, fPvv = rsd.Pgg_Pvv_Pgv(ks, mus, z,
                                       cc=Cosmology(fid), bg=bg)

    Ngg = 1.0 / nbar                           # shot noise [Mpc^3]
    Nvv = sigma_v ** 2 / nbar                  # velocity noise power

    F, FG = rsd.kmode_fisher(ks, mus, volume_mpc3, params,
                             dPgg, dPgv, dPvv,
                             np.asarray(fPgg), np.asarray(fPgv),
                             np.asarray(fPvv), Ngg, Nvv)

    sig_joint = np.sqrt(np.diag(np.linalg.inv(F)))
    sig_gonly = np.sqrt(np.diag(np.linalg.inv(FG)))
    print(f"{'param':>8} {'sigma (g+v)':>14} {'sigma (g only)':>16} "
          f"{'improvement':>12}")
    for p, sj, sg in zip(params, sig_joint, sig_gonly):
        print(f"{p:>8} {sj:14.5g} {sg:16.5g} {sg / sj:11.2f}x")
    assert np.all(sig_joint <= sig_gonly * (1 + 1e-9)), \
        "adding the velocity field must not lose information"
    print("OK")


if __name__ == "__main__":
    main()
