"""bench.py, the entry points and the small runtime helpers, on the CPU at
tiny sizes: every bench config runs its library path and names its
device, a failed config fails the run, the multi-device dry run takes
the devices it is given, and the compile cache honours its variable."""
import json
import os
import sys

import numpy as np
import pytest
import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tiny sizes for every config (the defaults are the GPU bench's)
_TINY = {
    "BENCH_N": "128", "BENCH_BATCH": "4", "BENCH_REPS": "1",
    "BENCH2_N": "128", "BENCH2_BATCH": "4", "BENCH2_REPS": "1",
    "BENCH3_N": "128", "BENCH3_BATCH": "2", "BENCH3_REPS": "1",
    "BENCH4_N": "128", "BENCH4_BATCH": "2", "BENCH4_REPS": "1",
    "BENCH5_NSTAMP": "8", "BENCH5_REPS": "1",
    "BENCH6_N": "128", "BENCH6_BATCH": "2", "BENCH6_REPS": "1",
    "BENCH7_LMAX": "31", "BENCH7_REPS": "1",
    "BENCH8_LMAX": "255", "BENCH8_BATCH": "2", "BENCH8_REPS": "1",
}


@pytest.fixture(scope="module")
def bench():
    sys.path.insert(0, ROOT)
    import bench
    return bench


@pytest.fixture
def tiny_env(monkeypatch):
    for k, v in _TINY.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("config", ["1", "2", "3", "4", "5", "6", "7", "8",
                                    "8p"])
def test_bench_config_runs_and_names_device(bench, tiny_env, monkeypatch,
                                            capsys, config):
    monkeypatch.setenv("BENCH_CONFIGS", config)
    bench.main()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    rec = lines[0]
    assert rec["platform"] == "cpu" and rec["device_count"] >= 1
    assert rec["device_kind"] and rec["value"] > 0


def test_bench_failed_config_exits_nonzero(bench, monkeypatch):
    monkeypatch.setenv("BENCH_CONFIGS", "5")

    def boom():
        raise RuntimeError("config failed")

    monkeypatch.setattr(bench, "bench_stack", boom)
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code not in (0, None)


def test_dryrun_multichip_on_given_devices():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    ge.dryrun_multichip(2, devices=jax.devices("cpu"))
    with pytest.raises(ValueError, match="need 64 devices"):
        ge.dryrun_multichip(64)


def test_dryrun_multichip_on_cpu_with_gpu_default(monkeypatch):
    """A GPU host's default binning (the CUDA kernel) still runs a dry run
    placed on CPU devices."""
    from orphics_tpu.ops import binning
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    monkeypatch.delenv("ORPHICS_TPU_BIN", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert binning._default_strategy() == "triton"
    ge.dryrun_multichip(2, devices=jax.devices("cpu"))


def test_entry_step_is_finite():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = np.asarray(jax.jit(fn)(*args))
    assert out.shape[0] == 3 and np.all(np.isfinite(out))


def test_compile_cache_dir(monkeypatch, tmp_path):
    from orphics_tpu.utils import compile_cache
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache.enable(str(tmp_path)) == str(
            tmp_path / ".jax_cache")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "x"))
        assert compile_cache.enable(str(tmp_path)) == str(tmp_path / "x")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "x")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_profiling_trace_raises_when_profiler_cannot_start(monkeypatch):
    from orphics_tpu.utils import profiling

    def fail(*a, **k):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(jax.profiler, "start_trace", fail)
    with pytest.raises(RuntimeError, match="profiler busy"):
        with profiling.trace("unused"):
            pass
