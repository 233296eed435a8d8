"""Sufficient-statistics Monte-Carlo accumulator on device meshes.

Device-mesh replacement for the reference's MPI reducers:
``orphics/stats.py:577`` ``Stats`` (tagged Send/Recv gather) and
``orphics/stats.py:918`` ``Statistics`` (``MPI.Allreduce(IN_PLACE, SUM)`` of
counts / sums / outer-product cross terms, ``stats.py:1209-1230``).

The reduction shape carries over unchanged — (N, Σx, Σxxᵀ) plus stack sums
— but the transport becomes ``jax.lax.psum`` over a mesh axis inside
``shard_map`` (ICI collectives), and intra-chip "ranks" are just a vmap'd
batch dimension. The accumulator is a pure pytree, so it threads through
``lax.scan`` loops and jit boundaries.

Derived statistics: mean = Σx/N, cov = (Σxxᵀ − Σx Σxᵀ/N)/(N − ddof),
identical to ``stats.py:1338-1394``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["SuffStats", "Statistics", "Stats", "get_stats",
           "dump_stats", "load_stats"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SuffStats:
    """Sufficient statistics of a stream of d-vectors (and optional stacks)."""

    n: jnp.ndarray          # scalar sample count
    s: jnp.ndarray          # (d,) running sum
    ss: Optional[jnp.ndarray] = None   # (d, d) running sum of outer products
    stack: Optional[jnp.ndarray] = None  # arbitrary-shape running stack sum
    nstack: Optional[jnp.ndarray] = None

    def tree_flatten(self):
        return (self.n, self.s, self.ss, self.stack, self.nstack), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    # ---- constructors ------------------------------------------------
    @staticmethod
    def zeros(dim: int, do_cov: bool = True, dtype=jnp.float32) -> "SuffStats":
        return SuffStats(
            n=jnp.zeros((), dtype),
            s=jnp.zeros((dim,), dtype),
            ss=jnp.zeros((dim, dim), dtype) if do_cov else None,
        )

    @staticmethod
    def zeros_stack(shape, dtype=jnp.float32) -> "SuffStats":
        return SuffStats(n=jnp.zeros((), dtype), s=jnp.zeros((0,), dtype),
                         ss=None, stack=jnp.zeros(shape, dtype),
                         nstack=jnp.zeros((), dtype))

    # ---- accumulation (pure) -----------------------------------------
    def add(self, x, w=None) -> "SuffStats":
        """Add one (d,) sample or a (B, d) batch; optional (B,) 0/1
        weights exclude padding entries from the statistics."""
        x = jnp.atleast_2d(x)
        if w is None:
            n_add = x.shape[0]
            xw = x
        else:
            w = jnp.asarray(w, x.dtype)
            n_add = w.sum()
            xw = x * w[:, None]
        new = dataclasses.replace(
            self,
            n=self.n + n_add,
            s=self.s + xw.sum(axis=0),
        )
        if self.ss is not None:
            new = dataclasses.replace(
                new, ss=self.ss + jnp.einsum("bi,bj->ij", xw, x,
                                             preferred_element_type=self.ss.dtype))
        return new

    def add_stack(self, arr, w=None) -> "SuffStats":
        """Add one array (or (B, ...) batch) to the running stack sum;
        optional (B,) 0/1 weights exclude padding entries."""
        arr = jnp.asarray(arr)
        if arr.ndim == self.stack.ndim:
            arr = arr[None]
        if w is None:
            n_add = arr.shape[0]
        else:
            w = jnp.asarray(w, arr.dtype)
            n_add = w.sum()
            arr = arr * w.reshape((-1,) + (1,) * (arr.ndim - 1))
        return dataclasses.replace(
            self, stack=self.stack + arr.sum(axis=0),
            nstack=self.nstack + n_add)

    # ---- reduction -----------------------------------------------------
    def psum(self, axis_name) -> "SuffStats":
        """All-reduce over a mesh axis (inside shard_map/pmap)."""
        return jax.tree_util.tree_map(
            lambda v: jax.lax.psum(v, axis_name) if v is not None else None, self)

    def merge(self, other: "SuffStats") -> "SuffStats":
        return jax.tree_util.tree_map(
            lambda a, b: a + b if a is not None else None, self, other)

    # ---- derived statistics --------------------------------------------
    def mean(self):
        return self.s / self.n

    def cov(self, ddof: int = 1):
        m = self.s[:, None] * self.s[None, :] / self.n
        return (self.ss - m) / (self.n - ddof)

    def var(self, ddof: int = 1):
        return jnp.diag(self.cov(ddof))

    def std(self, ddof: int = 1):
        return jnp.sqrt(self.var(ddof))

    def err(self):
        """Standard error of the mean."""
        return jnp.sqrt(self.var() / self.n)

    def corr(self, ddof: int = 1):
        c = self.cov(ddof)
        d = jnp.sqrt(jnp.diag(c))
        return c / d[:, None] / d[None, :]

    def stack_mean(self):
        return self.stack / self.nstack


_SUFF_FIELDS = ("n", "s", "ss", "stack", "nstack")


def state_to_arrays(state: Dict[str, SuffStats]) -> Dict[str, np.ndarray]:
    """Flatten a {label: SuffStats} dict to npz-ready arrays keyed
    ``{label}__{field}`` (the on-disk format of ``save_reduced`` and of
    the checkpointed-ensemble cursor files). Parsing is rsplit-based,
    so labels may themselves contain ``__``; field names never do."""
    out = {}
    for label, st in state.items():
        for field in _SUFF_FIELDS:
            v = getattr(st, field)
            if v is not None:
                out[f"{label}__{field}"] = np.asarray(v)
    return out


def state_from_arrays(data: Dict[str, np.ndarray]) -> Dict[str, SuffStats]:
    """Inverse of :func:`state_to_arrays`."""
    labels: Dict[str, Dict[str, jnp.ndarray]] = {}
    for k, v in data.items():
        label, field = k.rsplit("__", 1)
        labels.setdefault(label, {})[field] = jnp.asarray(v)
    return {label: SuffStats(**{f: fields.get(f) for f in _SUFF_FIELDS})
            for label, fields in labels.items()}


class Statistics:
    """Label-keyed accumulator with the reference's ``Statistics`` surface
    (``orphics/stats.py:918``): ``add``/``extend``/``add_stack`` then
    ``allreduce`` then ``mean/cov/var/stack_mean``.

    State is an explicit dict pytree so it can live inside jitted scan
    loops; this class is a thin stateful convenience for host-driven use.
    """

    def __init__(self):
        self.state: Dict[str, SuffStats] = {}

    def add(self, label: str, x, do_cov: bool = True):
        x = jnp.atleast_2d(jnp.asarray(x))
        if label not in self.state:
            self.state[label] = SuffStats.zeros(x.shape[-1], do_cov, x.dtype)
        self.state[label] = self.state[label].add(x)

    extend = add  # batch add is the same pure op

    def add_stack(self, label: str, arr, batched: bool = False):
        """Add a sample array (or, with ``batched``, a (B, ...) batch) to
        the running stack sum for ``label``."""
        arr = jnp.asarray(arr)
        if label not in self.state:
            shape = arr.shape[1:] if batched else arr.shape
            self.state[label] = SuffStats.zeros_stack(shape, arr.dtype)
        self.state[label] = self.state[label].add_stack(arr)

    def allreduce(self, axis_name=None):
        """On a single controller this is a no-op (all shards already
        merged); inside shard_map call ``SuffStats.psum`` directly."""
        return self

    def mean(self, label):
        return self.state[label].mean()

    def cov(self, label, ddof: int = 1):
        return self.state[label].cov(ddof)

    def var(self, label, ddof: int = 1):
        return self.state[label].var(ddof)

    def corr(self, label, ddof: int = 1):
        return self.state[label].corr(ddof)

    def err(self, label):
        return self.state[label].err()

    def stack_mean(self, label):
        return self.state[label].stack_mean()

    # ---- persistence (reference save_reduced/load_reduced,
    #      stats.py:1455-1530) -----------------------------------------
    def save_reduced(self, fname: str):
        np.savez(fname, **state_to_arrays(self.state))

    @classmethod
    def load_reduced(cls, fname: str) -> "Statistics":
        data = np.load(fname)
        obj = cls()
        obj.state.update(state_from_arrays(
            {k: data[k] for k in data.files}))
        return obj


class Stats(Statistics):
    """Back-compat alias of the older accumulator (reference
    ``orphics/stats.py:577``) — ``add_to_stats``/``add_to_stack``/
    ``get_stats`` naming."""

    def __init__(self, comm=None):
        super().__init__()

    def add_to_stats(self, label, x):
        self.add(label, x)

    def add_to_stack(self, label, arr):
        self.add_stack(label, arr)

    def dump(self, path):
        dump_stats(self, path)

    def get_stacks(self):
        self.stacks = {k: np.asarray(v.stack_mean())
                       for k, v in self.state.items() if v.stack is not None}
        return self.stacks

    def get_stats(self):
        self.stats = {}
        for k, v in self.state.items():
            if v.ss is None:
                continue
            cov = np.asarray(v.cov())
            err = np.sqrt(np.diag(cov))
            n = int(v.n)
            # reference key set/semantics (``orphics/stats.py:859``):
            # err = per-sample scatter, errmean = standard error of mean
            self.stats[k] = {
                "mean": np.asarray(v.mean()),
                "cov": cov,
                "covmean": cov / n,
                "corr": np.asarray(v.corr()),
                "err": err,
                "errmean": err / np.sqrt(n),
                "N": n,
            }
        return self.stats


def get_stats(binned_vectors):
    """mean/cov/covmean/err/errmean/corr of a (nsamples, dim) array —
    same keys and semantics as reference ``orphics/stats.py:859``:
    ``err`` is the per-sample scatter sqrt(diag cov) and ``errmean`` is
    the standard error of the mean err/sqrt(N)."""
    x = jnp.asarray(binned_vectors)
    st = SuffStats.zeros(x.shape[-1], dtype=x.dtype).add(x)
    n = int(st.n)
    cov = st.cov()
    err = jnp.sqrt(jnp.diag(cov))
    return {"mean": st.mean(), "cov": cov, "covmean": cov / n,
            "err": err, "errmean": err / np.sqrt(n),
            "corr": st.corr(), "N": n}


def dump_stats(stats: "Statistics", path: str):
    """Write a Statistics accumulator to a directory in the reference's
    ``Stats.dump`` layout (``stats.py:737``): per-label
    ``mstats_dump_vectors_<label>.npy`` sample matrices are not retained
    by the sufficient-statistics design, so this writes the reduced
    products — ``mstats_dump_stats_<label>_{mean,err,cov}.txt`` — plus
    ``mstats_dump_stack_<label>.npy`` stack means; round-trips through
    :func:`load_stats`."""
    import os
    os.makedirs(path, exist_ok=True)
    for label, st in stats.state.items():
        if st.stack is not None:
            np.save(os.path.join(path, f"mstats_dump_stack_{label}.npy"),
                    np.asarray(st.stack_mean()))
            continue
        np.savetxt(os.path.join(path,
                                f"mstats_dump_stats_{label}_mean.txt"),
                   np.atleast_1d(np.asarray(st.mean())))
        np.savetxt(os.path.join(path,
                                f"mstats_dump_stats_{label}_err.txt"),
                   np.atleast_1d(np.asarray(st.err())))
        if st.ss is not None:
            np.savetxt(os.path.join(path,
                                    f"mstats_dump_stats_{label}_cov.txt"),
                       np.atleast_2d(np.asarray(st.cov())))


def load_stats(path: str):
    """Load a directory written by :func:`dump_stats` (or the
    reference's ``Stats.dump``) into a simple namespace with ``stats``,
    ``stacks`` and ``vectors`` dicts (reference ``stats.py:744``)."""
    import glob
    import os
    import re
    import types
    s = types.SimpleNamespace(vectors={}, stats={}, stacks={})
    for sstr, sdict in (("vectors", s.vectors), ("stack", s.stacks)):
        for vfile in glob.glob(os.path.join(
                path, f"mstats_dump_{sstr}_*.npy")):
            key = re.search(rf"mstats_dump_{sstr}_(.*?)\.npy",
                            os.path.basename(vfile)).group(1)
            sdict[key] = np.load(vfile)
    keys = set()
    for vfile in glob.glob(os.path.join(path,
                                        "mstats_dump_stats_*_mean.txt")):
        keys.add(re.search(r"mstats_dump_stats_(.*?)_mean\.txt",
                           os.path.basename(vfile)).group(1))
    for key in keys:
        s.stats[key] = {}
        for vfile in glob.glob(os.path.join(
                path, f"mstats_dump_stats_{key}_*.txt")):
            skey = re.search(rf"mstats_dump_stats_{key}_(.*?)\.txt",
                             os.path.basename(vfile)).group(1)
            arr = np.loadtxt(vfile)
            if arr.size == 1:
                arr = arr.ravel()[0]
            s.stats[key][skey] = arr
    return s
