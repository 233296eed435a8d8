"""Grid-axis scaling: one big map sharded over devices.

The map-size scaling pattern (SURVEY §5.7): when a single map no longer
fits (or saturates) one chip, shard its rows over the mesh 'grid' axis
and run the whole masked-bandpower pipeline as ONE sharded program —
the pencil-decomposed distributed FFT (shard_map + all_to_all shard
transposes) plays the role of the reference's FFTW-MPI transforms, and
only a (nbins,) psum crosses devices at the end.

Runs on any device set — here the 8-device virtual CPU mesh,
identically on several GPUs.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     JAX_PLATFORMS=cpu python examples/distributed_fft.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere
import numpy as np
import jax

import jax.numpy as jnp

from orphics_tpu import rect_geometry
from orphics_tpu.models import theory, grf
from orphics_tpu.ops.windows import get_taper
from orphics_tpu.parallel import get_mesh
from orphics_tpu.parallel.fourier import fft2_dist, masked_bandpowers_dist

ndev = len(jax.devices())
mesh = get_mesh(shape=(1, ndev))  # every device on the 'grid' axis
print(f"mesh: {dict(mesh.shape)} on {ndev} {jax.default_backend()} "
      f"device(s)")

# a 2048^2 CMB map (rows divide the grid axis; >=4096^2 on real chips)
_QUICK = __import__("os").environ.get("ORPHICS_TPU_EXAMPLE_QUICK") == "1"
N = 512 if _QUICK else 2048
res = 0.5  # arcmin
geom = rect_geometry(width_arcmin=N * res, px_res_arcmin=res)
th = theory.default_theory()
ells = np.arange(20000)
mg = grf.MapGen(geom, np.asarray(th.lCl("TT", ells)))
m = mg.get_map(jax.random.PRNGKey(0))
taper, w2 = get_taper(geom, taper_percent=12.0)

# 1) the distributed FFT itself matches the serial transform
kd = fft2_dist(m.astype(jnp.complex64), mesh)
ks = jnp.fft.fft2(m)
fft_err = float(jnp.abs(kd - ks).max() / jnp.abs(ks).max())
print(f"fft2_dist vs serial max rel diff = {fft_err:.2e}")

# 2) the whole masked-bandpower pipeline as one sharded program
#    (mean power per annulus; norm = flat-sky power normalization)
edges = np.arange(200, 6000, 200.0)
ml = np.asarray(geom.modlmap())
dig = np.digitize(ml, edges).astype(np.int32)
dig[dig == len(edges)] = 0                     # overflow -> ignored bin
nbins = len(edges) - 1
norm = float(geom.area) / float(geom.npix) ** 2
bp = masked_bandpowers_dist(np.asarray(m, np.float32),
                            np.asarray(taper, np.float32),
                            dig, nbins, norm, mesh, axis="grid")
bp = np.asarray(bp) / float(w2)

cents = 0.5 * (edges[1:] + edges[:-1])
cl_th = np.asarray(th.lCl("TT", cents))
ratio = bp / cl_th
print(f"binned/theory over l in [200,6000): mean {ratio.mean():.3f} "
      f"+- {ratio.std() / np.sqrt(nbins):.3f}")

assert fft_err < 1e-4
assert abs(ratio.mean() - 1.0) < 0.05
print("OK")
