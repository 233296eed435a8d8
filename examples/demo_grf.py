"""GRF simulation -> FFT power -> binned bandpowers vs input theory.

The tutorial pipeline of reference ``tutorials/demo-grf.ipynb``, written
in JAX: the whole per-sim pipeline is jitted, the ensemble is a
vmap over PRNG keys (replace with orphics_tpu.parallel.ensemble_stats to
span a multi-chip mesh).

Run: python examples/demo_grf.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere

import numpy as np
import jax
import jax.numpy as jnp

from orphics_tpu import maps, io
from orphics_tpu.models import theory, grf
from orphics_tpu.stats import bin2D

_QUICK = __import__("os").environ.get("ORPHICS_TPU_EXAMPLE_QUICK") == "1"
nsims = 8 if _QUICK else 64
geom = maps.rect_geometry(width_deg=5.0 if _QUICK else 20.0, px_res_arcmin=2.0)
th = theory.default_theory()
ells = np.arange(th.lpad + 1)
cltt = np.asarray(th.lCl("TT", ells))

mgen = grf.MapGen(geom, cltt[None, None])
fc = maps.FourierCalc(geom)
edges = np.arange(100, 4000, 80.0)
binner = bin2D(np.asarray(geom.modlmap()), edges)


@jax.jit
def pipe(key):
    imap = mgen.get_map(key)
    p2d, _, _ = fc.power2d(imap)
    return binner.bin(p2d)[1]


p1ds = np.asarray(jax.vmap(pipe)(jax.random.split(jax.random.PRNGKey(0), nsims)))
mean = p1ds.mean(axis=0)
err = p1ds.std(axis=0, ddof=1) / np.sqrt(nsims)

cents = binner.centers
clth = np.interp(cents, ells, cltt)
print("bins:", len(cents))
print("max |mean/theory - 1|:", np.abs(mean / clth - 1).max())

pl = io.Plotter(scheme="Dell")
pl.add(ells[2:4000], cltt[2:4000], color="k", label="input theory")
pl.add_err(cents, mean, err, label=f"mean of {nsims} sims")
pl.done("demo_grf.png", verbose=True)
