"""orphics_tpu — a JAX flat-sky and curved-sky CMB analysis framework.

A ground-up JAX/XLA re-design of the capabilities of
``msyriac/orphics``: Gaussian-random-field CMB simulation, FFT power
spectra with radial binning, CMB lensing (sims, NFW profiles, quadratic
estimators, N_L^0), pixel-pixel covariance inpainting, ILC, foreground
models, Limber theory, Fisher forecasting, and device-mesh-distributed
Monte-Carlo statistics.

Layout:
  * ``ops``      — compute kernels: FFT calculus, radial binning,
                   interpolation/displacement, distance transforms.
  * ``models``   — physics: theory spectra, GRF synthesis, lensing & QE,
                   NFW, ILC, foregrounds, pixel covariances, noise.
  * ``parallel`` — device-mesh runtime: ensemble distribution and the
                   sufficient-statistics reducer (the MPI replacement).
  * ``utils``    — host-side config / IO / plotting glue.

Facade modules (``orphics_tpu.maps``, ``.stats``, ``.lensing``,
``.cosmology``, ``.pixcov``, ``.foregrounds``, ``.catalogs``, ``.io``,
``.mpi``) mirror the reference's public API so existing users can switch.
"""

from . import geometry
from .geometry import Geometry, rect_geometry

__version__ = "0.1.0"
