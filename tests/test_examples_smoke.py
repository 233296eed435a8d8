"""Every example must run end-to-end in quick mode (the reference's notebooks-as-integration-tests role,
``/root/reference/tutorials/``). ``ORPHICS_TPU_EXAMPLE_QUICK=1`` shrinks
sims/grids; each example runs in a CPU subprocess with a hard
timeout so a rotted example fails loudly, not silently.
"""
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*.py")))


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["ORPHICS_TPU_EXAMPLE_QUICK"] = "1"
    env["MPLBACKEND"] = "Agg"
    # share the repo's persistent XLA cache: the example tier is
    # compile-bound, and warm-cache runs are ~2.5x faster (1-core box)
    env.setdefault("JAX_COMPILATION_CACHE_DIR",
                   os.path.join(REPO, ".jax_cache"))
    env.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    flags.append("--xla_force_host_platform_device_count=8")
    env["XLA_FLAGS"] = " ".join(flags)
    return env


def test_examples_exist():
    assert len(EXAMPLES) >= 14, EXAMPLES


@pytest.mark.slow
@pytest.mark.parametrize("script", EXAMPLES,
                         ids=[os.path.basename(e) for e in EXAMPLES])
def test_example_runs_quick(script, tmp_path):
    res = subprocess.run([sys.executable, "-I", script], env=_env(),
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=420)
    assert res.returncode == 0, (
        f"{os.path.basename(script)} failed:\n"
        + res.stdout[-2000:] + "\n" + res.stderr[-3000:])
