"""Multi-device ensembles: mesh statistics + ring-distributed SHT.

The multi-chip usage pattern (SURVEY §2.3): build a Mesh, run a
Monte-Carlo ensemble data-parallel over the 'sims' axis with the
sufficient-statistics psum reduction (the reference's MPI
``Statistics.allreduce`` role), and run a curved-sky transform
ring-distributed over the same axis (the libsharp MPI strategy as
shard_map + psum). Runs on any device set — here the 8-device virtual
CPU mesh, identically on several GPUs.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     JAX_PLATFORMS=cpu python examples/mesh_ensemble.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere
import numpy as np
import jax


if jax.default_backend() == "cpu" and len(jax.devices()) == 1:
    print("hint: set XLA_FLAGS=--xla_force_host_platform_device_count=8 "
          "for a multi-device demo")
import jax.numpy as jnp

from orphics_tpu import rect_geometry, maps
from orphics_tpu.models import theory, grf
from orphics_tpu.ops.binning import Bin2D
from orphics_tpu.parallel import get_mesh, ensemble_stats
from orphics_tpu.ops import sht
from orphics_tpu.parallel import sht as psht

mesh = get_mesh()
print(f"mesh: {dict(mesh.shape)} on {mesh.devices.size} "
      f"{jax.default_backend()} device(s)")

# --- data-parallel ensemble with psum-reduced sufficient statistics ----
_QUICK = __import__("os").environ.get("ORPHICS_TPU_EXAMPLE_QUICK") == "1"
geom = rect_geometry(width_deg=5.0 if _QUICK else 10.0, px_res_arcmin=4.0)
th = theory.default_theory()
ells = np.arange(th.lpad + 1)
cltt = np.asarray(th.lCl("TT", ells))
mgen = grf.MapGen(geom, cltt[None, None])
fc = maps.FourierCalc(geom)
edges = np.arange(200, 2500, 200.0)
binner = Bin2D(geom.modlmap_np(), edges)


def sim(key):
    p2d, _, _ = fc.power2d(mgen.get_map(key))
    return {"p1d": binner.bin(p2d)[1]}


nsims = (2 if _QUICK else 8) * mesh.shape["sims"]
st = ensemble_stats(sim, nsims=nsims, key=jax.random.PRNGKey(0),
                    mesh=mesh, chunk=2)
mean = np.asarray(st["p1d"].mean())
err = np.asarray(st["p1d"].err())
from orphics_tpu.ops import fourier as F
_, clth = binner.bin(jnp.asarray(F.interp1d_to_2d(ells, cltt, geom,
                                                  dtype=jnp.float64)))
clth = np.asarray(clth)
nsig = np.abs(mean - clth) / np.maximum(err, 1e-30)
print(f"{nsims} sims over the mesh: max |mean - theory|/err = "
      f"{np.nanmax(nsig[:-2]):.2f} sigma")

# --- ring-distributed SHT over the same axis --------------------------
lmax = 32 if _QUICK else 64
rings = sht.gauss_legendre_rings(lmax)
m = curved_map = np.asarray(
    jax.random.normal(jax.random.PRNGKey(1), rings.shape))
a_dist = psht.map2alm_dist(jnp.asarray(m), rings, lmax, mesh)
a_ser = sht.map2alm(jnp.asarray(m), rings, lmax)
print("ring-distributed map2alm vs serial: max |diff| = "
      f"{float(jnp.abs(a_dist - a_ser).max()):.2e}")
m_back = psht.alm2map_dist(a_dist, rings, lmax, mesh)
print(f"distributed synthesis shape {m_back.shape}, finite: "
      f"{bool(jnp.isfinite(m_back).all())}")
