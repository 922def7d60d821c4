"""Two-stage pruned-transducer training step, data-parallel over a mesh.

This is the end-to-end flow the reference README prescribes to its users
(/root/reference/README.md:101-154) packaged as a library:

  1. simple loss (vocab-space additive joiner) with occupancy gradients
  2. pruning ranges from the occupancies
  3. prune the joiner-space projections
  4. full joiner on the pruned (B, T, s_range) pairs only
  5. pruned loss;   total = simple_scale * simple + pruned_scale * pruned

Distribution: utterances are batch-sharded over the mesh 'data' axis
(shard_map); parameters are replicated; the only collective is the gradient
psum inserted by vma-aware autodiff (see parallel/sharding.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from ..ops.losses import rnnt_loss_pruned, rnnt_loss_simple
from ..ops.pruning import do_rnnt_pruning, get_rnnt_prune_ranges
from ..parallel.sharding import DATA_AXIS
from .transducer import PrunedTransducer, TransducerConfig

__all__ = [
    "LossConfig",
    "pruned_transducer_loss",
    "make_train_step",
    "init_model",
]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    s_range: int = 5
    simple_scale: float = 0.5
    pruned_scale: float = 1.0
    rnnt_type: str = "regular"
    delay_penalty: float = 0.0
    impl: Optional[str] = None


def make_boundary(out_lens: jax.Array, symbol_lens: jax.Array) -> jax.Array:
    B = out_lens.shape[0]
    zeros = jnp.zeros((B,), jnp.int32)
    return jnp.stack(
        [zeros, zeros, symbol_lens.astype(jnp.int32), out_lens.astype(jnp.int32)],
        axis=1,
    )


def pruned_transducer_loss(
    params: Any,
    model: PrunedTransducer,
    features: jax.Array,
    feature_lens: jax.Array,
    symbols: jax.Array,
    symbol_lens: jax.Array,
    loss_cfg: LossConfig = LossConfig(),
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Total loss (sum over the batch) + metrics dict."""
    blank = model.cfg.blank_id
    am, lm, simple_am, simple_lm, out_lens = model.apply(
        params, features, feature_lens, symbols
    )
    boundary = make_boundary(out_lens, symbol_lens)

    simple_loss, (px_grad, py_grad) = rnnt_loss_simple(
        simple_lm,
        simple_am,
        symbols,
        termination_symbol=blank,
        boundary=boundary,
        rnnt_type=loss_cfg.rnnt_type,
        delay_penalty=loss_cfg.delay_penalty,
        reduction="sum",
        calc_gradients=True,
        impl=loss_cfg.impl,
    )
    ranges = get_rnnt_prune_ranges(px_grad, py_grad, boundary, loss_cfg.s_range)
    am_pruned, lm_pruned = do_rnnt_pruning(am, lm, ranges)
    logits = model.apply(params, am_pruned, lm_pruned, method=PrunedTransducer.join)
    pruned_loss = rnnt_loss_pruned(
        logits,
        symbols,
        ranges,
        termination_symbol=blank,
        boundary=boundary,
        rnnt_type=loss_cfg.rnnt_type,
        delay_penalty=loss_cfg.delay_penalty,
        reduction="sum",
        impl=loss_cfg.impl,
    )
    total = loss_cfg.simple_scale * simple_loss + loss_cfg.pruned_scale * pruned_loss
    metrics = {
        "loss": total,
        "simple_loss": simple_loss,
        "pruned_loss": pruned_loss,
        "frames": jnp.sum(out_lens),
    }
    return total, metrics


def init_model(
    rng: jax.Array,
    cfg: TransducerConfig,
    batch_size: int = 2,
    num_frames: int = 32,
    num_symbols: int = 8,
) -> Tuple[PrunedTransducer, Any]:
    """Create the model and initialize every submodule's params."""
    model = PrunedTransducer(cfg)
    feats = jnp.zeros((batch_size, num_frames, cfg.feature_dim), jnp.float32)
    lens = jnp.full((batch_size,), num_frames, jnp.int32)
    syms = jnp.zeros((batch_size, num_symbols), jnp.int32)
    params = model.init(rng, feats, lens, syms, method=PrunedTransducer.init_all)
    return model, params


def make_train_step(
    model: PrunedTransducer,
    optimizer: optax.GradientTransformation,
    mesh: Optional[jax.sharding.Mesh] = None,
    loss_cfg: LossConfig = LossConfig(),
    axis_name: str = DATA_AXIS,
):
    """Build a jitted (optionally data-parallel) train step:

        new_params, new_opt_state, metrics = step(params, opt_state, batch)

    ``batch`` = (features, feature_lens, symbols, symbol_lens), batch-sharded
    over the mesh when one is given.
    """

    def loss_fn(params, batch):
        feats, feat_lens, syms, sym_lens = batch
        return pruned_transducer_loss(
            params, model, feats, feat_lens, syms, sym_lens, loss_cfg
        )

    def local_step(params, opt_state, batch):
        grads, metrics = jax.grad(loss_fn, has_aux=True)(params, batch)
        if mesh is not None:
            # grads are already psum'd by vma-aware AD (params replicated);
            # metrics are shard-local sums -> reduce explicitly.
            metrics = jax.tree_util.tree_map(
                lambda x: jax.lax.psum(x, axis_name), metrics
            )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, metrics

    if mesh is None:
        return jax.jit(local_step)

    mapped = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P(), P(axis_name)),
        out_specs=(P(), P(), P()),
    )
    return jax.jit(mapped)
