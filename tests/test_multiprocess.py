"""Genuine multi-process `jax.distributed` execution of the mesh runtime.

The reference's real multi-host pattern
(``orphics/mpi.py:62-74`` — an MPI world of separate processes) exercised
with >1 actual process, not a mocked world: two CPU processes x two
virtual devices each bootstrap through ``init_multihost``, run one
``ensemble_stats`` psum over the 4-device global mesh (collectives ride
Gloo across the process boundary), and the reduced moments must equal
the single-process 4-device computation.
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    jax.config.update('jax_platforms', 'cpu')
    pid, nproc, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    sys.path.insert(0, {repo!r})
    from orphics_tpu.parallel.runtime import (init_multihost, get_mesh,
                                              ensemble_stats)
    rank, size = init_multihost(coordinator_address='localhost:' + port,
                                num_processes=nproc, process_id=pid)
    assert (rank, size) == (pid, nproc), (rank, size)
    assert len(jax.devices()) == 4, jax.devices()  # global mesh is 4 either way
    mesh = get_mesh()

    def fn(key):
        return {{"x": jax.random.normal(key, (5,))}}

    st = ensemble_stats(fn, nsims=16, key=jax.random.PRNGKey(3),
                        mesh=mesh, chunk=1)
    assert int(np.asarray(st["x"].n)) == 16
    if rank == 0:
        np.savez(out, mean=np.asarray(st["x"].mean()),
                 cov=np.asarray(st["x"].cov()))
    print("worker", rank, "done", flush=True)
""").format(repo=REPO)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cpu_env(ndev_local):
    env = dict(os.environ)
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        env.pop(var, None)
    env["JAX_PLATFORMS"] = "cpu"
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    flags.append(f"--xla_force_host_platform_device_count={ndev_local}")
    env["XLA_FLAGS"] = " ".join(flags)
    return env


@pytest.mark.slow
def test_two_process_ensemble_stats_matches_single_process(tmp_path):
    port = _free_port()
    out = str(tmp_path / "rank0.npz")
    script = str(tmp_path / "worker.py")
    with open(script, "w") as f:
        f.write(WORKER)
    env = _cpu_env(2)
    procs = [subprocess.Popen(
        [sys.executable, "-I", script, str(pid), "2", str(port), out],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        outs.append(o)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    d = np.load(out)

    # single-process 4-device reference in an identically-configured
    # (x64-off, CPU-only) subprocess: the key-split and dtype must match
    # the workers' so the comparison is exact, not statistical
    out1 = str(tmp_path / "single.npz")
    single = subprocess.run(
        [sys.executable, "-I", script, "0", "1", str(_free_port()), out1],
        env=_cpu_env(4), cwd=str(tmp_path), capture_output=True,
        text=True, timeout=300)
    assert single.returncode == 0, single.stdout[-2000:] + single.stderr[-2000:]
    s = np.load(out1)
    np.testing.assert_allclose(d["mean"], s["mean"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(d["cov"], s["cov"], rtol=0, atol=1e-6)
