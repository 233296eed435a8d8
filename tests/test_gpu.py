"""The GPU against the references, at sizes between the CPU tests' and the
chip smoke test's. Skipped (by the ``gpu_device`` fixture) where JAX's
default device is not a GPU; run with ``make gpu-test``."""
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def test_bin_kernel_compiled_vs_bincount(gpu_device):
    from orphics_tpu.ops.bin_kernel import bin_sums
    rng = np.random.default_rng(0)
    for nmaps, npix, nseg in [(1, 5000, 40), (6, 131584, 38),
                              (192, 65536, 100)]:
        x = rng.exponential(size=(nmaps, npix)).astype(np.float32)
        ids = rng.integers(-1, nseg + 1, npix).astype(np.int32)
        got = np.asarray(bin_sums(jnp.asarray(x), jnp.asarray(ids), nseg),
                         np.float64)
        ok = (ids >= 0) & (ids < nseg)
        ref = np.stack([np.bincount(ids[ok], weights=r[ok].astype(
            np.float64), minlength=nseg) for r in x])
        np.testing.assert_allclose(got, ref, rtol=2e-6)


def test_phase_flat_on_gpu(gpu_device, smoke):
    out = smoke.phase_flat(n=512, px=2.0, nmaps=4, nbin_maps=32, nsims=16,
                           lrange=(500.0, 4000.0))
    assert out["bin"] <= 2e-6


def test_phase_lensing_on_gpu(gpu_device, smoke):
    out = smoke.phase_lensing(n=256, px=2.0, batch=16, cmp_batch=2,
                              run_entry=False)
    assert out["device_vs_cpu"] <= 1e-4


def test_phase_curved_on_gpu(gpu_device, smoke):
    out = smoke.phase_curved(lmax=511, lmax_spin=255, lmax_mc=511,
                             mc_batch=4)
    assert out["rt0"] <= 1e-5 and out["rt2"] <= 1e-5
