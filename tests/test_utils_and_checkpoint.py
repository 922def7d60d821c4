"""Tests for validation, profiling utilities, and checkpoint/resume."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

import fast_rnnt_tpu as frt
from fast_rnnt_tpu.utils import benchmark_fn, check_rnnt_inputs, device_memory_stats
from fast_rnnt_tpu.utils.validation import checkify_rnnt_inputs


def test_static_validation_messages():
    lm = jnp.zeros((2, 5, 10))
    am = jnp.zeros((2, 8, 10))
    sym = jnp.zeros((2, 4), jnp.int32)
    check_rnnt_inputs(lm=lm, am=am, symbols=sym, termination_symbol=0)
    with pytest.raises(ValueError, match="vocab mismatch"):
        check_rnnt_inputs(lm=lm, am=jnp.zeros((2, 8, 11)), symbols=sym)
    with pytest.raises(ValueError, match="batch dim"):
        check_rnnt_inputs(lm=lm, am=jnp.zeros((3, 8, 10)))
    with pytest.raises(ValueError, match="termination_symbol"):
        check_rnnt_inputs(lm=lm, am=am, termination_symbol=10)
    with pytest.raises(ValueError, match="symbols must be integer"):
        check_rnnt_inputs(symbols=jnp.zeros((2, 4)))
    with pytest.raises(ValueError, match="boundary must be"):
        check_rnnt_inputs(boundary=jnp.zeros((2, 3), jnp.int32))
    # and the losses call it
    with pytest.raises(ValueError, match="lm must be"):
        frt.rnnt_loss_simple(jnp.zeros((2, 5)), am, sym, 0)


def test_checkify_validation():
    from jax.experimental import checkify

    sym = jnp.asarray([[1, 2], [3, 9]], jnp.int32)
    bnd = jnp.asarray([[0, 0, 2, 5], [0, 0, 2, 5]], jnp.int32)

    def run(sym):
        checkify_rnnt_inputs(sym, C=10, boundary=bnd, S=2, T=5)
        return 0

    err, _ = checkify.checkify(run)(sym)
    err.throw()  # all fine

    err, _ = checkify.checkify(run)(jnp.asarray([[1, 2], [3, 12]], jnp.int32))
    with pytest.raises(Exception, match="symbols must be < C"):
        err.throw()


def test_benchmark_fn_runs():
    f = jax.jit(lambda x: jnp.sum(x * 2))
    dt = benchmark_fn(f, jnp.ones((128, 128)), iters=3, warmup=1)
    assert dt > 0
    if jax.devices()[0].memory_stats() is None:  # the CPU client keeps none
        with pytest.raises(RuntimeError, match="memory_stats"):
            device_memory_stats()
    else:
        assert device_memory_stats()["peak_mb_in_use"] > 0


def test_checkpoint_roundtrip(tmp_path):
    from fast_rnnt_tpu.models.checkpoint import (
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )

    params = {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.ones((3,))}
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    save_checkpoint(str(tmp_path / "ck"), 7, params, opt_state)
    assert latest_step(str(tmp_path / "ck")) == 7
    step, restored = restore_checkpoint(
        str(tmp_path / "ck"), template={"params": params, "opt_state": opt_state}
    )
    assert step == 7
    np.testing.assert_array_equal(restored["params"]["w"], params["w"])
    leaves_a = jax.tree_util.tree_leaves(restored["opt_state"])
    leaves_b = jax.tree_util.tree_leaves(opt_state)
    assert len(leaves_a) == len(leaves_b)
