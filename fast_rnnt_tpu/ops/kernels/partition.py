"""GSPMD/pjit composition for opaque kernel calls (the GPU recursion's FFI
calls).

The RNN-T lattice kernels are embarrassingly parallel over the batch
dimension (the reference CUDA kernels index ``b`` independently,
mutual_information_cuda.cu:244-248), but an FFI custom call is an opaque
unit to XLA's partitioner: under plain ``jit`` with batch-sharded inputs
it would be replicated on every device.  This module runs such a call per
batch shard, so plain-``jit`` users keep the kernels.

Two mechanisms, matching JAX's two sharding worlds:

* **Explicit-axes meshes** (``jax.make_mesh`` default): shardings are
  visible on tracer types (``jax.typeof(x).sharding``), so the wrapper
  detects batch-sharded inputs at trace time, ``reshard``\\ s every
  operand to a batch-only sharding, and runs the kernel under an
  internal ``jax.shard_map`` over the batch mesh axes.  Outputs marked
  ``"sum"`` (cross-batch reductions, e.g. the smoothed build's unigram
  cotangent) get a ``psum`` inside the shard_map body.

* **Auto-axes meshes** (classic GSPMD, ``jax.sharding.Mesh`` default):
  shardings are invisible at trace time, so the whole dispatcher is
  wrapped in ``jax.experimental.custom_partitioning`` whose callbacks
  force batch-only operand shardings and run the kernel per-shard.

Inside an outer ``shard_map`` (the ``parallel.data_parallel`` wrappers)
operand specs are hidden (manual axes), so both mechanisms fall through
to the plain kernel call — the wrappers compose, they don't stack.

If the batch size does not divide the batch-axis shard count, the
wrapper replicates instead (correct, not fast) — the kernels assume
equal per-shard batches.

No reference equivalent: the reference is single-GPU (SURVEY.md §2.4);
this is part of our own distribution design.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

__all__ = ["batch_only", "batch_partitioned"]

# Test seam: when set, called as hook(name, per_shard_batch) each time a
# kernel is traced on the PARTITIONED path (internal shard_map or
# custom_partitioning lowering) — never on the plain fallthrough.  Lets
# tests assert the kernels genuinely ran per-shard instead of replicated.
_TRACE_HOOK = None


def _spec_and_sharding(x):
    """(PartitionSpec, sharding) of a tracer/array, or (None, None)."""
    try:
        sh = jax.typeof(x).sharding
        return getattr(sh, "spec", None), sh
    except Exception:
        return None, None


def _norm_axes(entry) -> Tuple[str, ...]:
    """PartitionSpec entry -> tuple of mesh-axis names."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def _batch_only_spec(rank: int, ax: Optional[int], batch) -> P:
    if ax is None or batch is None:
        return P(*([None] * rank))
    return P(*[batch if d == ax else None for d in range(rank)])


def _axis_types_ok(mesh, names: Tuple[str, ...]) -> bool:
    """True iff every mesh axis in ``names`` is Explicit (resharding and
    trace-time specs only exist in the explicit world)."""
    try:
        by_name = dict(zip(mesh.axis_names, mesh.axis_types))
        explicit = jax.sharding.AxisType.Explicit
        return all(by_name.get(n) == explicit for n in names)
    except Exception:
        return False


def _mesh_extent(mesh, names: Tuple[str, ...]) -> int:
    n = 1
    for name in names:
        n *= mesh.shape[name]
    return n


def batch_only(*arrays):
    """Reshard explicitly-sharded batch-major arrays (batch at axis 0) so
    that only the batch axis is sharded, over the largest batch sharding
    any of them has.  The losses call this on their inputs: under an
    explicit-axes mesh, an input sharded along another axis (e.g. ``lm``
    along the vocabulary) would otherwise meet batch-sharded operands in
    an elementwise op that JAX rejects.  The transpose of ``reshard``
    returns each gradient in its input's sharding.  ``None`` entries and
    arrays without explicit shardings pass through unchanged."""
    specs, mesh = [], None
    for a in arrays:
        spec, sh = (None, None) if a is None else _spec_and_sharding(a)
        specs.append(spec)
        if spec is not None and any(_norm_axes(e) for e in spec):
            mesh = mesh or getattr(sh, "mesh", None)
    if mesh is None:
        return arrays
    names = set().union(*[set(_norm_axes(e)) for s in specs if s is not None
                          for e in s])
    if not _axis_types_ok(mesh, names):
        return arrays
    batch = max(
        (_norm_axes(s[0]) for s in specs if s is not None and len(s)),
        key=lambda n: _mesh_extent(mesh, n) if n else 0,
    )
    out = []
    for a, spec in zip(arrays, specs):
        if a is None or spec is None:
            out.append(a)
            continue
        b = batch if batch and a.shape[0] % _mesh_extent(mesh, batch) == 0 else None
        want = _batch_only_spec(a.ndim, 0, b or None)
        if tuple(spec) + (None,) * (a.ndim - len(spec)) != tuple(want):
            a = jax.sharding.reshard(a, NamedSharding(mesh, want))
        out.append(a)
    return tuple(out)


class _BatchPartitioned:
    """Callable wrapping ``fn`` (positional arrays -> tuple of arrays)."""

    def __init__(self, fn, in_axes, out_axes, in_ranks, out_ranks, name):
        self._fn = fn
        self._in_axes = tuple(in_axes)
        self._out_axes = tuple(out_axes)
        self._in_ranks = tuple(in_ranks)
        self._out_ranks = tuple(out_ranks)
        self._name = name
        self._cp = self._make_cp()

    # --- shared sharding logic -------------------------------------------

    def _find_batch(self, specs, shapes, mesh=None):
        """Mesh-axis names the batch dim is sharded over.  When several
        batch-carrying operands disagree (sharded over different mesh
        axes), pick the candidate with the LARGEST mesh extent — the
        others are resharded up to it, so no operand's parallelism is
        silently dropped; () when none is sharded."""
        candidates: list[Tuple[str, ...]] = []
        for spec, ax in zip(specs, self._in_axes):
            if spec is None or ax is None or ax >= len(spec):
                continue
            names = _norm_axes(spec[ax])
            if names and names not in candidates:
                candidates.append(names)
        if not candidates:
            return ()
        if mesh is None or len(candidates) == 1:
            return candidates[0]
        return max(candidates, key=lambda n: _mesh_extent(mesh, n))

    def _divisible(self, batch, mesh, args_shapes) -> bool:
        if not batch:
            return False
        n = _mesh_extent(mesh, batch)
        for shape, ax in zip(args_shapes, self._in_axes):
            if ax is not None and shape[ax] % n != 0:
                return False
        return True

    def _psum_body(self, batch):
        fn = self._fn
        out_axes = self._out_axes
        in_axes = self._in_axes
        name = self._name

        def body(*args):
            if _TRACE_HOOK is not None:
                for a, ax in zip(args, in_axes):
                    if ax is not None:
                        _TRACE_HOOK(name, a.shape[ax])
                        break
            outs = fn(*args)
            if batch:
                outs = tuple(
                    jax.lax.psum(o, batch) if ax == "sum" else o
                    for o, ax in zip(outs, out_axes)
                )
            return outs

        return body

    # --- explicit world: trace-time dispatch ------------------------------

    def _dispatch(self, *args):
        specs = []
        mesh = None
        any_sharded = False
        for a in args:
            spec, sh = _spec_and_sharding(a)
            specs.append(spec)
            if spec is not None and any(_norm_axes(e) for e in spec):
                any_sharded = True
                if mesh is None:
                    mesh = getattr(sh, "mesh", None)
        if not any_sharded or mesh is None:
            return self._fn(*args)

        batch = self._find_batch(specs, [a.shape for a in args], mesh)
        if not _axis_types_ok(mesh, set().union(
            *[set(_norm_axes(e)) for s in specs if s is not None for e in s]
        )):
            # auto/manual axes leak no specs; anything else (mixed-type
            # meshes) is out of scope — run the kernel as-is
            return self._fn(*args)
        if not self._divisible(batch, mesh, [a.shape for a in args]):
            batch = ()

        in_specs = tuple(
            _batch_only_spec(a.ndim, ax, batch or None)
            for a, ax in zip(args, self._in_axes)
        )
        args = tuple(
            jax.sharding.reshard(a, NamedSharding(mesh, s))
            for a, s in zip(args, in_specs)
        )
        if not batch:
            return self._fn(*args)
        out_specs = tuple(
            P(*([None] * r)) if ax == "sum" else _batch_only_spec(r, ax, batch)
            for r, ax in zip(self._out_ranks, self._out_axes)
        )
        return jax.shard_map(
            self._psum_body(batch), mesh=mesh,
            in_specs=in_specs, out_specs=out_specs, check_vma=False,
        )(*args)

    # --- auto world: custom_partitioning ----------------------------------

    def _rule(self) -> str:
        """Shardy sharding rule: the batch factor is shared, every other
        dim is its own factor (sharding only propagates along batch)."""
        names = iter(f"d{i}" for i in range(10000))

        def term(rank, ax):
            return " ".join(
                "b" if (ax is not None and ax != "sum" and d == ax)
                else next(names)
                for d in range(rank)
            )

        ins = ", ".join(term(r, ax)
                        for r, ax in zip(self._in_ranks, self._in_axes))
        outs = ", ".join(term(r, ax)
                         for r, ax in zip(self._out_ranks, self._out_axes))
        return f"{ins} -> {outs}"

    def _shardings(self, mesh, arg_shapes, result_shapes):
        specs = [getattr(s.sharding, "spec", None) for s in arg_shapes]
        batch = self._find_batch(specs, [s.shape for s in arg_shapes], mesh)
        if not self._divisible(batch, mesh, [s.shape for s in arg_shapes]):
            batch = ()
        b = batch or None
        arg_sh = tuple(
            NamedSharding(mesh, _batch_only_spec(r, ax, b))
            for r, ax in zip(self._in_ranks, self._in_axes)
        )
        out_sh = tuple(
            NamedSharding(
                mesh,
                P(*([None] * r)) if ax == "sum"
                else _batch_only_spec(r, ax, b),
            )
            for r, ax in zip(self._out_ranks, self._out_axes)
        )
        return batch, arg_sh, out_sh

    def _make_cp(self):
        from jax.experimental.custom_partitioning import custom_partitioning

        cp = custom_partitioning(self._dispatch)

        def infer(mesh, arg_shapes, result_shape):
            _, _, out_sh = self._shardings(mesh, arg_shapes, result_shape)
            return out_sh

        def partition(mesh, arg_shapes, result_shape):
            batch, arg_sh, out_sh = self._shardings(
                mesh, arg_shapes, result_shape
            )
            return mesh, self._psum_body(batch), out_sh, arg_sh

        cp.def_partition(
            infer_sharding_from_operands=infer,
            partition=partition,
            sharding_rule=self._rule(),
        )
        return cp

    def __call__(self, *args):
        return self._cp(*args)


def batch_partitioned(
    fn,
    in_axes: Sequence[Optional[int]],
    out_axes: Sequence[Union[int, str]],
    in_ranks: Sequence[int],
    out_ranks: Sequence[int],
    name: str = "kernel",
):
    """Wrap a tuple-in/tuple-out kernel entry so it composes with GSPMD.

    Args:
      fn: positional-array function returning a TUPLE of arrays; must be
        batch-separable (every output row b depends only on input rows b).
      in_axes: per argument, the index of its batch dimension, or None
        for replicated (batch-free) arguments.
      out_axes: per output, the index of its batch dimension, or the
        string ``"sum"`` for outputs that are reductions over the batch
        (summed across shards with a psum).
      in_ranks / out_ranks: static ranks (the shardy rule needs them
        before the first call).
      name: diagnostic label.
    """
    return _BatchPartitioned(fn, in_axes, out_axes, in_ranks, out_ranks, name)
