"""Native halo-model thermal-SZ power vs the shipped Battaglia template.

Computes C_l^yy from first principles — Battaglia pressure profiles,
Tinker mass function, Limber 1-halo + 2-halo integrals as vmapped
quadrature (reference ``compute_cl_yy``/``compute_tsz_power``,
``foregrounds.py:123,168``) — and compares against the repository's
shipped Battaglia y-power template, then converts to thermodynamic uK^2
at 150 GHz.

Run: python examples/tsz_halomodel.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere

import numpy as np

from orphics_tpu import io
from orphics_tpu.models import szhalo, foregrounds as fg

# Evaluate at the template's own simulation cosmology (Battaglia et al.
# 2012: sigma8=0.8, Om=0.25, h=0.72) — C_l^yy scales roughly as
# sigma8^8, so the comparison is only meaningful at matched parameters.
from orphics_tpu.models.cosmology import Cosmology, As_from_s8
params = dict(omch2=0.25 * 0.72 ** 2 - 0.043 * 0.72 ** 2,
              ombh2=0.043 * 0.72 ** 2, H0=72.0, ns=0.96, tau=0.09)
params["As"] = As_from_s8(0.8, params=params)
cc = Cosmology(params)

ells = np.geomspace(100, 9000, 40)
clyy = szhalo.compute_cl_yy(ells, cc=cc)
clyy_1h = szhalo.compute_cl_yy(ells, include_2h=False, cc=cc)
template = np.asarray(fg.power_y_template(ells))

d = ells * (ells + 1) / (2 * np.pi)
pl = io.Plotter(xlabel=r"$\ell$",
                ylabel=r"$\ell(\ell+1) C_\ell^{yy} / 2\pi$",
                xscale="log", yscale="log")
pl.add(ells, d * clyy, label="halo model (1h + 2h)")
pl.add(ells, d * clyy_1h, ls="--", label="1-halo only")
pl.add(ells, d * template, color="k", ls=":",
       label="shipped Battaglia template")
pl.done("tsz_halomodel.png", verbose=True)

sel = (ells > 300) & (ells < 8000)
ratio = clyy[sel] / template[sel]
print(f"halo-model / template over l in (300, 8000): "
      f"median {np.median(ratio):.2f}, range "
      f"[{ratio.min():.2f}, {ratio.max():.2f}]")
cl150 = szhalo.compute_tsz_power(ells, 150.0, 150.0, Cyy=clyy)  # uses clyy above
print(f"tSZ power at 150 GHz, l=3000: "
      f"{np.interp(3000, ells, ells*(ells+1)*cl150/(2*np.pi)):.2f} uK^2")
