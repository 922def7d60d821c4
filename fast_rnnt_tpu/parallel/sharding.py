"""Data-parallel distribution over device meshes.

The reference has NO distribution machinery at all (SURVEY.md §2.4: no
tf.distribute, no NCCL/MPI, single-GPU only) — this subsystem is designed
from scratch:

  * The RNN-T loss is per-utterance: every lattice is independent along the
    batch axis, so the natural (and optimal) distribution is batch/data
    parallelism — utterances sharded across chips, the loss computed fully
    locally, and only the model-gradient psum crossing devices (NVLink
    within a host).
  * We express it with `jax.sharding.Mesh` + NamedSharding (GSPMD inserts
    nothing for the loss itself — there is no cross-batch math) and provide
    an explicit `shard_map` wrapper for users who want guaranteed-local
    execution with a hand-placed psum.

All helpers work identically on several GPUs, a single one, or a
virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "batch_sharding",
    "shard_batch",
    "data_parallel",
    "data_parallel_value_and_grad",
    "initialize_distributed",
]

DATA_AXIS = "data"


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    axis_name: str = DATA_AXIS,
) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def batch_sharding(mesh: Mesh, axis_name: str = DATA_AXIS) -> NamedSharding:
    """Sharding that splits axis 0 (the utterance/batch axis) over the mesh."""
    return NamedSharding(mesh, P(axis_name))


def shard_batch(tree: Any, mesh: Mesh, axis_name: str = DATA_AXIS) -> Any:
    """device_put every array in ``tree`` with its batch axis sharded.

    Scalars / rank-0 leaves are replicated.
    """
    sharded = batch_sharding(mesh, axis_name)
    replicated = NamedSharding(mesh, P())

    def put(x):
        x = jax.numpy.asarray(x)
        return jax.device_put(x, sharded if x.ndim >= 1 else replicated)

    return jax.tree_util.tree_map(put, tree)


def data_parallel(
    fn: Callable[..., Any],
    mesh: Mesh,
    axis_name: str = DATA_AXIS,
    reduce_outputs: bool = False,
) -> Callable[..., Any]:
    """Wrap a batched function so it runs shard-locally over the mesh.

    Every positional argument must carry the batch on axis 0.  With
    ``reduce_outputs=False`` outputs keep their (sharded) batch axis; with
    ``True`` each output is psum-reduced over the data axis (for
    pre-reduced scalar losses).
    """
    in_specs = P(axis_name)
    out_specs = P() if reduce_outputs else P(axis_name)

    def local_fn(*args):
        out = fn(*args)
        if reduce_outputs:
            out = jax.tree_util.tree_map(
                lambda x: jax.lax.psum(x, axis_name), out
            )
        return out

    mapped = jax.shard_map(
        local_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs
    )
    return jax.jit(mapped)


def data_parallel_value_and_grad(
    loss_fn: Callable[..., jax.Array],
    mesh: Mesh,
    axis_name: str = DATA_AXIS,
) -> Callable[..., Any]:
    """Data-parallel ``value_and_grad`` for a training step.

    ``loss_fn(params, *batch)`` must return a scalar that is a SUM over its
    (local) batch shard.  Parameters are replicated; batch args are sharded
    on axis 0.  Returns ``(loss, grads)`` where both are psum'd across the
    mesh — the only collective in the whole pipeline.
    """

    def local_step(params, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, *batch)
        # The local loss is device-varying -> reduce it explicitly.  The
        # grads are NOT psum'd here: params enter replicated (unvarying), so
        # vma-aware autodiff already inserts the cross-device psum when
        # transposing the replicated->varying broadcast.
        loss = jax.lax.psum(loss, axis_name)
        return loss, grads

    mapped = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P(axis_name)),
        out_specs=(P(), P()),
    )

    @jax.jit
    def step(params, *batch):
        return mapped(params, batch)

    return step


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host initialization (standard JAX runtime; no-op if already
    initialized or single-process).  Call once per host before building
    meshes that span hosts."""
    # Structural no-op checks FIRST (not error-message sniffing, which is
    # brittle across JAX versions): nothing to initialize single-process,
    # and re-init of an already-initialized runtime is benign.
    if coordinator_address is None and num_processes in (None, 1):
        return
    if _distributed_is_initialized():
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        # A racing/earlier init elsewhere in the process is the one benign
        # failure left; anything else (bad coordinator address, firewalled
        # port) must propagate — otherwise each host would silently fall
        # back to single-process and train without gradient sync.
        if _distributed_is_initialized():
            return
        raise


def _distributed_is_initialized() -> bool:
    """True iff jax.distributed has a live client (structural check)."""
    try:
        return jax.distributed.is_initialized()
    except AttributeError:  # older jax: inspect the global state object
        state = getattr(jax.distributed, "global_state", None)
        return getattr(state, "client", None) is not None
