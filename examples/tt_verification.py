"""TT (and EB) quadratic-estimator verification: reconstruct kappa from
lensed simulations and check <C_L(recon x input)> / <C_L(input)> == 1.

The canonical end-to-end validation of reference
``tutorials/tt_verification.ipynb``, in JAX: sim + lensing + QE
reconstruction compile into one program per sim; the ensemble is a vmap
(or a multi-chip ensemble via orphics_tpu.parallel).

Run: python examples/tt_verification.py [nsims]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere

import sys

import numpy as np
import jax
import jax.numpy as jnp

from orphics_tpu import maps, io
from orphics_tpu.ops import fourier as F
from orphics_tpu.models import theory, lensing, qe
from orphics_tpu.stats import bin2D

_QUICK = __import__("os").environ.get("ORPHICS_TPU_EXAMPLE_QUICK") == "1"
nsims = int(sys.argv[1]) if len(sys.argv) > 1 else (8 if _QUICK else 64)
beam, noise = 1.5, 1.0
geom = maps.rect_geometry(width_deg=6.4, px_res_arcmin=3.0)  # 128^2
th = theory.default_theory()

fls = lensing.FlatLensingSims(geom, th, beam_arcmin=beam, noise_uk_arcmin=noise)
ctot = qe.lensing_noise_2d(geom, th, beam, noise)
q = qe.QE(geom, th, ctot,
          xmask=F.mask_kspace(geom, lmin=100, lmax=3000),
          kmask=F.mask_kspace(geom, lmin=40, lmax=500))
kbeam = F.gauss_beam(geom.modlmap(), beam)
binner = bin2D(np.asarray(geom.modlmap()), np.arange(60, 480, 60.0))
norm = jnp.float32(geom.area / geom.npix ** 2)


@jax.jit
def pipe(key):
    kc, kk, kn = jax.random.split(key, 3)
    unlensed = fls.get_unlensed(kc)
    kappa = fls.get_kappa(kk)
    lensed = fls.lens(unlensed, kappa)
    observed = F.kfilter(lensed, fls.kbeam, geom) + fls.ngen.get_map(kn)
    kobs = jnp.fft.fft2(observed) / jnp.maximum(kbeam, 1e-8)
    fkrec = q.kappa_from_map("TT", kobs)
    fkin = jnp.fft.fft2(kappa)
    _, cross = binner.bin((fkrec.conj() * fkin).real * norm)
    _, auto = binner.bin((fkin.conj() * fkin).real * norm)
    return cross, auto


cross, auto = jax.vmap(pipe)(jax.random.split(jax.random.PRNGKey(0), nsims))
cross, auto = np.asarray(cross), np.asarray(auto)
ratio = cross.mean(axis=0) / auto.mean(axis=0)
err = cross.std(axis=0, ddof=1) / np.sqrt(nsims) / auto.mean(axis=0)
print("L bins:", binner.centers.astype(int))
print("recon/input ratio:", np.round(ratio, 3))
print("sigma:", np.round(err, 3))
print("verification %s" % ("PASSED" if np.all(np.abs(ratio - 1) < 5 * err + 0.1)
                           else "FAILED"))

pl = io.Plotter(xlabel="$L$", ylabel=r"$C_L^{\hat\kappa\kappa}/C_L^{\kappa\kappa}-1$")
pl.add_err(binner.centers, ratio - 1, err, label="TT QE")
pl.hline(0.0)
pl.done("tt_verification.png", verbose=True)
