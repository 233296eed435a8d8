"""FastCl: the batched sim -> bandpower engine.

The flagship performance API (the fast replacement for the reference's
MapGen + FourierCalc.power2d + bin2D Monte-Carlo loop): half-plane GRF
synthesis, rfft2 power and radial binning in one jitted program. This
demo runs a small grid so it is quick on CPU too.

Run: python examples/fastcl_demo.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere

import numpy as np
import jax
import jax.numpy as jnp

from orphics_tpu import rect_geometry, io
from orphics_tpu.models import theory
from orphics_tpu.models.fastcl import FastCl
from orphics_tpu.ops.windows import get_taper

_QUICK = __import__("os").environ.get("ORPHICS_TPU_EXAMPLE_QUICK") == "1"
n = 256 if _QUICK else 512
geom = rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
th = theory.default_theory()
ells = np.arange(th.lpad + 1)
cltt = np.asarray(th.lCl("TT", ells))
edges = np.arange(100, 4000, 80.0)
fc = FastCl(geom, ells, cltt, bin_edges=edges)

# 1) simulate straight to bandpowers (no map ever returned)
nsims = 8 if _QUICK else 32
bp = np.asarray(fc.sim_bandpowers(3, nsims))      # int seed -> PRNG key
mean, err = bp.mean(0), bp.std(0, ddof=1) / np.sqrt(nsims)

# 2) bandpowers of existing maps, and masked cross spectra
from orphics_tpu.models import grf
mgen = grf.MapGen(geom, cltt[None, None])
maps = mgen.get_maps(jax.random.split(jax.random.PRNGKey(0), 8))
auto = np.asarray(fc.map_bandpowers(maps))
taper, w2 = get_taper(geom, taper_percent=12.0)
cross = np.asarray(fc.cross_bandpowers(
    maps[:4], maps[:4], window=jnp.asarray(np.asarray(taper),
                                           jnp.float32))) / w2

cents = np.asarray(fc.centers)
clth = np.interp(cents, ells, cltt)
print(f"sim_bandpowers over {nsims} sims: "
      f"mean/theory - 1 = {np.median(mean / clth) - 1:+.3f}")
print(f"map_bandpowers({len(maps)} maps): "
      f"median ratio {np.median(np.median(auto, axis=0) / clth):.3f}")
print(f"masked auto-cross (w2-debiased): "
      f"median ratio {np.median(np.median(cross, axis=0) / clth):.3f}")

pl = io.Plotter(scheme="Dell")
pl.add(ells[2:4000], cltt[2:4000], color="k", label="input theory")
pl.add_err(cents, mean, err, label=f"FastCl sims ({nsims})")
pl.add(cents, np.median(cross, axis=0), ls="--",
       label="masked cross (taper)")
pl.done("fastcl_demo.png", verbose=True)
