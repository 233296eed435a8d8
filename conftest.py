"""Test harness config.

Default: run everything on a virtual 8-device CPU mesh with float64
enabled (the environment must be set before the first ``import jax``
anywhere in the test process; pytest imports this conftest first).

Tests marked ``gpu`` compare the card against the references. They take
the ``gpu_device`` fixture, which skips them where JAX's default device is
not a GPU. Run them on a machine with a GPU: ``make gpu-test``
(``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu -q``).
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_CPU_ONLY = os.environ["JAX_PLATFORMS"] == "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from orphics_tpu.utils import compile_cache  # noqa: E402

# Persistent XLA compile cache: the suite is compile-bound on repeat runs.
compile_cache.enable(os.path.dirname(os.path.abspath(__file__)))

if _CPU_ONLY:
    # Tests exercise float64 closed-form identities (the reference is
    # float64 numpy); production paths pass explicit float32 dtypes.
    jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: compares a GPU against the references (run: make gpu-test)")
    config.addinivalue_line(
        "markers", "slow: multi-process / large-shape tests")
    config.addinivalue_line(
        "markers",
        "quick: fast regression tier (python -m pytest tests/ -m quick)")


@pytest.fixture(scope="session")
def gpu_device():
    """The GPU the ``gpu`` tests run on; skips where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX default device is {dev.platform}); "
                    "run make gpu-test on a machine with one")
    return dev


# Known-heavy tests that must not represent their module in the quick
# tier (jit-compile-bound or large-shape).
_QUICK_EXCLUDE = (
    "4096", "multichip", "two_process", "example_runs", "checkpoint",
    "lensed_cls", "roundtrip_lmax", "smoke",
)


def pytest_collection_modifyitems(config, items):
    # `-m quick` regression tier: the first non-slow, non-gpu test of
    # every module is auto-marked quick (plus anything explicitly
    # marked). One test per module keeps the tier under ~2 min.
    seen = set()
    for it in items:
        mod = getattr(it, "module", None)
        name = getattr(mod, "__name__", None)
        if name is None or name in seen:
            continue
        if "slow" in it.keywords or "gpu" in it.keywords:
            continue
        if any(tok in it.name.lower() for tok in _QUICK_EXCLUDE):
            continue
        seen.add(name)
        it.add_marker(pytest.mark.quick)
