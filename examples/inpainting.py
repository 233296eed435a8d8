"""Batched maximum-likelihood inpainting of circular holes.

Reference ``examples/inpainting.py`` pattern: the per-source geometry
precompute (dense inverse + Woodbury deprojection) is a single vmapped
program over all sources instead of an MPI loop, and the per-map fill is
one batched matmul.

Run: python examples/inpainting.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere

import numpy as np
import jax
import jax.numpy as jnp

from orphics_tpu import maps, io, pixcov
from orphics_tpu.ops import fourier as F
from orphics_tpu.models import theory, grf
from orphics_tpu.models.noise import white_noise

_QUICK = __import__("os").environ.get("ORPHICS_TPU_EXAMPLE_QUICK") == "1"
geom = maps.rect_geometry(width_deg=4.0 if _QUICK else 8.0, px_res_arcmin=2.0)
th = theory.default_theory()
noise_level = 15.0
beam_fn = lambda ells: F.gauss_beam(ells, 1.4)

# simulate a beam-convolved CMB + white-noise map
ells = np.arange(th.lpad + 1)
mgen = grf.MapGen(geom, np.asarray(th.lCl("TT", ells))[None, None])
k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
sig = F.kfilter(mgen.get_map(k1), F.gauss_beam(geom.modlmap(), 1.4), geom)
imap = sig + white_noise(k2, geom, noise_level)

# sources to inpaint (pixel coordinates)
rng = np.random.default_rng(1)
coords = rng.integers(40, geom.ny - 40, size=(25, 2))

filled = pixcov.inpaint(imap, coords, geom, th, beam_fn,
                        noise_uk_arcmin=noise_level, hole_radius_arcmin=6.0,
                        npix_context=24, key=k3)

resid = np.asarray(filled - imap)
print("pixels changed:", int((np.abs(resid) > 0).sum()))
print("fill rms / map rms:", float(resid[np.abs(resid) > 0].std()
                                   / np.asarray(imap).std()))
io.plot_img(np.asarray(imap), "inpaint_before.png")
io.plot_img(np.asarray(filled), "inpaint_after.png")
io.plot_img(resid, "inpaint_diff.png")
