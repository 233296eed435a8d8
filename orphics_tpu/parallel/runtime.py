"""Device-mesh ensemble runtime — the MPI replacement.

Replaces the reference's ``orphics/mpi.py`` (``mpi_distribute``/
``distribute``, ``fakeMpiComm``) and the MPI ensemble loops of SURVEY §3.5:

  * task distribution over ranks        ->  PRNG keys split over a batch
                                            axis, shard_map'd over a mesh
  * ``MPI.Allreduce`` of suff. stats    ->  ``jax.lax.psum`` over the mesh
  * ``fakeMpiComm`` serial fallback     ->  a 1-device mesh (always works)

Design: the user writes a per-simulation function ``fn(key) -> pytree of
1D vectors`` and calls :func:`ensemble`; we vmap it within each device in
chunks, scan over chunks, accumulate :class:`SuffStats` in-register, and
psum across the ``sims`` mesh axis. One compiled program, no host traffic
until the final reduced pytree.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .statistics import SuffStats

__all__ = ["get_mesh", "distribute", "mpi_distribute", "ensemble",
           "ensemble_stats", "ensemble_stats_checkpointed",
           "init_multihost"]


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, local_device_ids=None):
    """Bootstrap multi-process JAX — the analog of the reference's MPI
    world setup (``orphics/mpi.py:62-74``: import mpi4py, fall back to
    ``fakeMpiComm`` when absent).

    Multi-process runs pass ``coordinator_address`` (``host:port`` of
    process 0) / ``num_processes`` / ``process_id`` explicitly or set the
    standard ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` env vars. After this, ``jax.devices()`` is the
    *global* device list, so :func:`get_mesh` meshes span every process
    and the ``psum``-reduced ensembles run unchanged.

    Without a coordinator this is a no-op — the ``fakeMpiComm``
    degradation. Calling twice is safe. Returns
    ``(process_index, process_count)``.
    """
    import os

    if not (coordinator_address
            or os.environ.get("JAX_COORDINATOR_ADDRESS")):
        return 0, 1
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id,
            local_device_ids=local_device_ids)
    except RuntimeError as e:
        # idempotence: a second initialize raises; anything else is real
        if "already" not in str(e).lower():
            raise
    return jax.process_index(), jax.process_count()


def get_mesh(shape=None, axis_names=("sims", "grid"), devices=None) -> Mesh:
    """Build a device mesh. Default: all devices on the ``sims`` axis and a
    trivial ``grid`` axis (flat-sky ensembles are data-parallel first; the
    grid axis is for sharding very large maps / covariance rows)."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    arr = np.array(devices).reshape(shape)
    return Mesh(arr, axis_names=axis_names)


def mpi_distribute(num_tasks: int, num_cores: int, allow_empty: bool = False):
    """Contiguous task chunking with the remainder on the *last* ranks —
    same assignment policy AND return signature as reference
    ``orphics/mpi.py:78`` (rank 0 is never overloaded). Returns
    ``(num_each, task_dist)``: a per-core count array and a list of
    task-index lists per core."""
    if not allow_empty:
        assert num_cores <= num_tasks, "fewer tasks than cores"
    base = num_tasks // num_cores
    rem = num_tasks % num_cores
    counts = [base + (1 if i >= num_cores - rem else 0) for i in range(num_cores)]
    out, start = [], 0
    for c in counts:
        out.append(list(range(start, start + c)))
        start += c
    return np.asarray(counts), out


def distribute(nsims: int, key=None, mesh: Optional[Mesh] = None):
    """Split ``nsims`` tasks into per-device PRNG key batches.

    The key-split is the device-native analog of reference
    ``mpi.distribute(Nsims)`` (``orphics/mpi.py:95``): every task gets an
    independent, reproducible random stream regardless of device count.
    Returns (mesh, keys) with keys shaped (ndev, nsims_per_dev, 2).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    if mesh is None:
        mesh = get_mesh()
    ndev = mesh.devices.size
    per = math.ceil(nsims / ndev)
    keys = jax.random.split(key, ndev * per).reshape(ndev, per, -1)
    return mesh, keys


from functools import lru_cache as _lru_cache


@_lru_cache(maxsize=32)
def _ensemble_stats_prog(fn, stack_fn, mesh: Mesh, per: int, chunk: int,
                         do_cov: bool):
    """Compiled-program cache for :func:`ensemble_stats`: jit keys on
    callable identity, so building a fresh shard_map wrapper per call
    would re-trace/compile every round of a Monte-Carlo loop (the
    checkpointed ensemble calls this once per round). ``nsims`` enters
    as a traced operand so every equal-``per`` round shares one
    executable."""
    probe = jax.eval_shape(fn, jax.random.PRNGKey(0))
    zeros = {k: SuffStats.zeros(int(np.prod(v.shape)), do_cov, v.dtype)
             for k, v in probe.items()}
    if stack_fn is not None:
        sprobe = jax.eval_shape(stack_fn, jax.random.PRNGKey(0))
        szeros = {k: SuffStats.zeros_stack(v.shape, v.dtype)
                  for k, v in sprobe.items()}
    else:
        szeros = {}

    def device_body(dev_keys, nsims):
        # dev_keys: (per, 2) on each device; nsims: replicated scalar
        nchunks = per // chunk
        dev = jax.lax.axis_index("sims")

        def step(state, scanned):
            ck, cstart = scanned
            # zero-weight the keys beyond the requested nsims (the count
            # is rounded up to ndev*chunk; padding must not bias stats)
            gidx = dev * per + cstart + jnp.arange(chunk)
            valid = (gidx < nsims).astype(jnp.float32)
            vals = jax.vmap(fn)(ck)
            st, sst = state
            st = {k: st[k].add(vals[k].reshape(chunk, -1), w=valid)
                  for k in st}
            if stack_fn is not None:
                svals = jax.vmap(stack_fn)(ck)
                sst = {k: sst[k].add_stack(svals[k], w=valid) for k in sst}
            return (st, sst), 0.0

        ck = dev_keys.reshape(nchunks, chunk, -1)
        cstarts = jnp.arange(nchunks) * chunk
        (st, sst), _ = jax.lax.scan(step, (zeros, szeros), (ck, cstarts))
        st = {k: v.psum("sims") for k, v in st.items()}
        sst = {k: v.psum("sims") for k, v in sst.items()}
        return st, sst

    sharded = jax.shard_map(device_body, mesh=mesh,
                            in_specs=(P("sims"), P()),
                            out_specs=jax.tree_util.tree_map(lambda _: P(), (zeros, szeros)),
                            check_vma=False)
    return jax.jit(sharded)


def ensemble_stats(fn: Callable, nsims: int, key=None, mesh: Optional[Mesh] = None,
                   chunk: int = 1, do_cov: bool = True,
                   stack_fn: Optional[Callable] = None):
    """Run ``fn(key) -> dict[str, 1D vector]`` for ``nsims`` independent
    seeds across the mesh and return fully-reduced :class:`SuffStats` per
    label (the ``Statistics.allreduce`` pattern of ``orphics/stats.py:1184``
    compiled into one program).

    ``chunk``: how many sims to vmap together per scan step on each device
    (trades device memory for dispatch overhead).
    ``stack_fn``: optional ``fn(key) -> dict[str, array]`` of map-like
    outputs to be stack-summed (``add_to_stack`` analog).
    """
    if mesh is None:
        mesh = get_mesh()
    ndev = mesh.shape["sims"]
    per = math.ceil(nsims / ndev / chunk) * chunk
    if key is None:
        key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, ndev * per)
    keys = keys.reshape(ndev * per, -1)
    prog = _ensemble_stats_prog(fn, stack_fn, mesh, per, int(chunk),
                                bool(do_cov))
    st, sst = prog(keys, jnp.asarray(nsims, jnp.int32))
    st = dict(st)
    st.update(sst)
    return st


def ensemble(fn: Callable, nsims: int, key=None, mesh: Optional[Mesh] = None,
             chunk: int = 1):
    """Gather (not reduce) per-sim outputs: returns the stacked pytree of
    ``fn(key)`` over ``nsims`` seeds, computed data-parallel over the mesh.
    For small outputs (binned spectra); use :func:`ensemble_stats` when
    only moments are needed."""
    if mesh is None:
        mesh = get_mesh()
    ndev = mesh.shape["sims"]
    per = math.ceil(nsims / ndev)
    if key is None:
        key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, ndev * per).reshape(ndev * per, -1)

    def device_body(dev_keys):
        return jax.lax.map(fn, dev_keys)

    out_probe = jax.eval_shape(fn, jax.random.PRNGKey(0))
    sharded = jax.shard_map(device_body, mesh=mesh, in_specs=P("sims"),
                            out_specs=jax.tree_util.tree_map(lambda _: P("sims"), out_probe),
                            check_vma=False)
    out = jax.jit(sharded)(keys)
    return jax.tree_util.tree_map(lambda v: v[:nsims], out)


def ensemble_stats_checkpointed(fn: Callable, nsims: int, path: str,
                                every: int = None, key=None,
                                mesh: Optional[Mesh] = None,
                                chunk: int = 1, do_cov: bool = True,
                                stack_fn: Optional[Callable] = None,
                                _interrupt_after: int = None):
    """Preemption-safe :func:`ensemble_stats`: run the Monte Carlo in
    rounds of ``every`` sims, persisting the accumulated sufficient
    statistics and a round cursor to ``path`` (atomic ``os.replace``)
    after each round. Re-invoking with the same arguments loads the
    completed rounds and computes only the remainder — the device-native
    version of the reference's long MPI loops that dump
    ``Statistics`` periodically so a killed job can resume
    (``orphics/stats.py`` dump/load usage).

    Determinism across interruptions: round ``r`` always draws its keys
    from ``fold_in(key, r)``, so the result is bitwise identical to an
    uninterrupted run with the same ``every``. A fingerprint of
    ``(nsims, every, chunk, key, mesh sims size)`` guards against
    resuming with different arguments (raises ``ValueError``) — the
    sims-axis size matters because :func:`ensemble_stats` splits keys
    per device, so a resumed pod of a different size would draw a
    different stream.

    ``_interrupt_after`` is a testing hook: stop (returning ``None``)
    after that many newly-computed rounds, as a stand-in for
    preemption.
    """
    import os
    from .statistics import state_to_arrays, state_from_arrays
    if mesh is None:
        mesh = get_mesh()
    if key is None:
        key = jax.random.PRNGKey(0)
    if every is None:
        every = max(int(mesh.shape["sims"]) * chunk, 1)
    nrounds = math.ceil(nsims / every)
    fhash = repr((int(nsims), int(every), int(chunk), bool(do_cov),
                  int(mesh.shape["sims"]),
                  np.asarray(key).tolist(), stack_fn is not None))
    _META = ("fingerprint", "rounds_done")

    def _save(state, rounds_done):
        flat = state_to_arrays(state)
        flat["fingerprint"] = np.asarray(fhash)
        flat["rounds_done"] = np.asarray(rounds_done)
        tmp = path + ".tmp.npz"          # np.savez keeps an .npz suffix
        np.savez(tmp, **flat)
        os.replace(tmp, path)

    def _load():
        if not os.path.exists(path):
            return None, 0
        with np.load(path, allow_pickle=False) as z:
            if str(z["fingerprint"]) != fhash:
                raise ValueError(
                    f"checkpoint {path} was written with different "
                    "arguments (nsims/every/chunk/key/mesh); refusing "
                    "to mix")
            rounds_done = int(z["rounds_done"])
            state = state_from_arrays({k: z[k] for k in z.files
                                       if k not in _META})
        return state, rounds_done

    state, r0 = _load()
    done = 0
    for r in range(r0, nrounds):
        count = min(every, nsims - r * every)
        st = ensemble_stats(fn, count, key=jax.random.fold_in(key, r),
                            mesh=mesh, chunk=chunk, do_cov=do_cov,
                            stack_fn=stack_fn)
        st = jax.tree_util.tree_map(np.asarray, st)  # off-device
        state = st if state is None else \
            {k: state[k].merge(st[k]) for k in state}
        _save(state, r + 1)
        done += 1
        if _interrupt_after is not None and done >= _interrupt_after \
                and r + 1 < nrounds:
            return None
    return state


import contextlib as _contextlib


@_contextlib.contextmanager
def mpi_abort_on_exception(comm=None):
    """Abort all ranks on an uncaught exception with a rank-0 traceback
    (reference ``mpi.py:31``). With the mesh runtime there are no
    separate processes to abort, so this prints the traceback once and
    re-raises — same developer surface, single-controller semantics."""
    import sys
    import traceback
    try:
        yield
    except Exception as e:
        rank = comm.Get_rank() if comm is not None else 0
        if rank == 0:
            print(f"Exception: {e}", file=sys.stderr)
            traceback.print_exc()
        if comm is not None and hasattr(comm, "Abort"):
            comm.Abort(1)
        raise
