"""Curved-sky pipeline: rand_map -> beam smoothing -> mask -> masked Cls.

The curved-sky counterpart of demo_grf: synthesize full-sky CMB GRFs on
Gauss-Legendre rings with the native SHT (the reference's
``pixell.curvedsky.rand_map`` / ``hp.anafast`` roles, reference
``maps.py:744,1009``), smooth with a Gaussian beam, apply a galactic
strip mask and recover the input spectrum with the w2 correction.

Run: python examples/curved_sky_demo.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere

import numpy as np
import jax
import jax.numpy as jnp

from orphics_tpu import io
from orphics_tpu.models import theory, curved
from orphics_tpu.ops import sht
from orphics_tpu.ops import alm as almops

_QUICK = __import__("os").environ.get("ORPHICS_TPU_EXAMPLE_QUICK") == "1"
lmax = 63 if _QUICK else 255
nsims = 4 if _QUICK else 16
rings = sht.gauss_legendre_rings(lmax)
th = theory.default_theory()
ells = np.arange(lmax + 1)
cltt = np.asarray(th.lCl("TT", ells))
fwhm = 30.0  # arcmin

# galactic strip mask (|b| > ~14 deg kept), with the gal->equ rotation
mask = np.asarray(curved.galactic_mask_rings(rings, np.deg2rad(76.0),
                                             np.deg2rad(104.0),
                                             coords="equ"))
w2 = float(curved.wfactor(2, jnp.asarray(mask), rings))


@jax.jit
def pipe(key):
    m = curved.rand_map(key, rings, jnp.asarray(cltt), lmax)
    sm = curved.smoothing(m, rings, fwhm, lmax)
    alm = sht.map2alm(sm * jnp.asarray(mask), rings, lmax)
    return curved.masked_cls(alm, w2)


cls = np.asarray(jax.vmap(pipe)(jax.random.split(jax.random.PRNGKey(0),
                                                 nsims)))
mean = cls.mean(axis=0)
bl = np.exp(-0.5 * ells * (ells + 1)
            * (np.deg2rad(fwhm / 60.0) / np.sqrt(8 * np.log(2))) ** 2)
expected = cltt * bl ** 2
sel = (ells > 20) & (ells < 200)
ratio = mean[sel] / expected[sel]
print(f"masked-Cl / (Cl b_l^2) over l in (20, 200): "
      f"mean {ratio.mean():.3f}, rms {ratio.std():.3f}")

pl = io.Plotter(xlabel=r"$\ell$", ylabel=r"$C_\ell\ [\mu K^2]$",
                yscale="log")
pl.add(ells[2:], cltt[2:], color="k", label="input theory")
pl.add(ells[2:], expected[2:], color="k", ls="--",
       label=r"theory $\times b_\ell^2$")
pl.add(ells[2:], mean[2:], label=f"masked mean of {nsims} curved sims")
pl.done("curved_sky_demo.png", verbose=True)
