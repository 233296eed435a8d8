"""Tracing / profiling utilities (SURVEY §5.1).

The reference's tracing layer is minimal: ``pixell.bench.show`` context
blocks (reference ``lensing.py:152``, ``pixcov.py:3``,
``foregrounds.py:10``) and a ``stats.timeit`` wall-time decorator
(reference ``stats.py:902-913``). This build keeps those shapes and
adds ``jax.profiler`` traces that can be opened in XProf/TensorBoard or
Perfetto, and named scopes that label compiled regions inside a jitted
program.

Usage::

    from orphics_tpu.utils import profiling as prof

    with prof.trace("/tmp/jaxtrace"):          # device + host trace
        out = step(keys)
        prof.sync(out)

    with prof.show("qe recon"):                # bench.show analog
        out = step(keys)
        prof.sync(out)

    @jax.jit
    def step(x):
        with prof.annotate("filter"):          # label inside jit
            y = filt(x)
        return bin(y)

``bench.py`` honors ``BENCH_TRACE=<logdir>`` to wrap the timed reps of
every config in a profiler trace.
"""
from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "annotate", "show", "sync", "timeit"]

from .fitting import timeit  # re-export: decorator form lives there


def sync(out):
    """Block until ``out`` is actually computed
    (``jax.block_until_ready`` over every leaf)."""
    return jax.block_until_ready(out)


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """``jax.profiler.trace`` wrapper: captures a device+host trace into
    ``logdir`` (open with XProf / TensorBoard's profile plugin, or the
    generated Perfetto link). A profiler that cannot start raises."""
    jax.profiler.start_trace(logdir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named scope usable inside jitted code: XLA ops emitted under this
    context carry ``name`` in their metadata, so kernels group under it
    in trace viewers. (``jax.named_scope`` — works under ``jit``; for
    host-side spans around dispatch use :func:`trace` + TraceAnnotation.)
    """
    return jax.named_scope(name)


@contextlib.contextmanager
def show(label: str = "block"):
    """The ``pixell.bench.show`` analog: wall-time a block and print it.

    Blocks are synced by the *caller* (call :func:`sync` on the block's
    outputs before leaving it) — an un-synced async dispatch would time
    at ~0. Prints ``<label>: <seconds> s`` like the reference.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        print(f"{label}: {time.perf_counter() - t0:.6f} s")
