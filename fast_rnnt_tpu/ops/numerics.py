"""Log-space / linear-recurrence numerics for the RNN-T lattice recursion.

Design note (the XLA scan core)
-------------------------------
The reference implementation (tf_fast_rnnt/csrc/
mutual_information_cuda.cu:174-422) evaluates the two-term DP recursion with a
warp-synchronous anti-diagonal wavefront; so does this library's GPU kernel
(ops/kernels/mutual_information.cu).  The portable XLA formulation instead
observes that for a *fixed* row ``s`` the recursion

    p[s, t] = logaddexp(a[t], p[s, t-1] + c[t-1])

is a first-order linear recurrence over ``t`` in the (logaddexp, +)
log-semiring.  First-order linear recurrences compose associatively: the
element ``(A_t, b_t)`` representing ``x_t = (A_t (x) x_{t-1}) (+) b_t``
composes as

    (A1, b1) then (A2, b2)  ==  (A1 (x) A2,  (b1 (x) A2) (+) b2)

so the whole row can be evaluated with ``lax.associative_scan`` in
O(log T) depth and O(T) work, vectorized over (batch x T).  The lattice
then needs only S+1 *sequential* steps (a ``lax.scan`` over the symbol
axis), each built from plain XLA operations on any backend.

The backward recursion has the same structure in ordinary (+, *) algebra.

Numerical contract (mirrors the reference semantics):
  * ``LogAdd`` (mutual_information.h:54-83): -inf-safe; returns the max when
    the difference is NaN (e.g. both args -inf).
  * ``safe_exp`` (mutual_information_cuda.cu:430-439): exp() that maps
    inf/NaN results (and NaN inputs) to 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "logaddexp",
    "safe_exp",
    "log_linear_scan",
    "linear_scan",
    "reverse_linear_scan",
    "NEG_INF",
]

# True -inf is used throughout (with NaN-safe logaddexp/safe_exp below);
# the reference instead clamps lattice values to -1e30 in its backward
# (mutual_information_cuda.cu:629-637) — unnecessary here.
NEG_INF = float("-inf")


def logaddexp(x: jax.Array, y: jax.Array) -> jax.Array:
    """-inf/NaN-safe ``log(exp(x) + exp(y))``.

    Matches the reference ``LogAdd`` semantics
    (/root/reference/tf_fast_rnnt/csrc/mutual_information.h:54-83):
    when ``x - y`` is NaN (both -inf, or a NaN input) the max is returned,
    so ``logaddexp(-inf, -inf) == -inf`` with no NaN propagation.
    """
    amax = jnp.maximum(x, y)
    diff = -jnp.abs(x - y)
    out = amax + jnp.log1p(jnp.exp(diff))
    # diff is NaN only when both inputs are -inf (lattice values are never
    # +inf) <=> amax == -inf, so one select restores the -inf; a NaN input
    # makes amax NaN and the select keeps out (= NaN) either way — the same
    # "return the max" contract as the reference LogAdd.
    return jnp.where(amax == NEG_INF, NEG_INF, out)


def safe_exp(x: jax.Array) -> jax.Array:
    """exp(x) with inf/NaN results mapped to 0.

    Mirrors ``safe_exp`` in the reference backward kernel
    (mutual_information_cuda.cu:430-439): occupancy terms computed from
    -inf/-inf differences must contribute exactly zero gradient.
    """
    # Zero exactly the arguments whose exp would overflow fp32 (inf) or is
    # NaN — the same set the reference's post-hoc isinf/isnan check zeroes
    # (float32 exp overflows just above 88.72).
    bad = jnp.isnan(x) | (x > 88.6)
    return jnp.where(bad, 0.0, jnp.exp(jnp.where(bad, 0.0, x)))


def _log_combine(left, right):
    """Compose two log-semiring affine elements (earlier `left`, later `right`)."""
    a1, b1 = left
    a2, b2 = right
    return a1 + a2, logaddexp(b1 + a2, b2)


def log_linear_scan(coeff: jax.Array, bias: jax.Array, axis: int = -1) -> jax.Array:
    """Solve ``x_t = logaddexp(coeff_t + x_{t-1}, bias_t)`` with ``x_{-1} = -inf``.

    All arrays share a shape; the recurrence runs along ``axis``.  Returns the
    full solution ``x``.  ``coeff[..., 0]`` is ignored (multiplies x_{-1}).
    """
    _, x = jax.lax.associative_scan(_log_combine, (coeff, bias), axis=axis)
    return x


def _lin_combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, b1 * a2 + b2


def linear_scan(coeff: jax.Array, bias: jax.Array, axis: int = -1) -> jax.Array:
    """Solve ``x_t = coeff_t * x_{t-1} + bias_t`` with ``x_{-1} = 0``."""
    _, x = jax.lax.associative_scan(_lin_combine, (coeff, bias), axis=axis)
    return x


def reverse_linear_scan(coeff: jax.Array, bias: jax.Array, axis: int = -1) -> jax.Array:
    """Solve ``x_t = coeff_t * x_{t+1} + bias_t`` with ``x_{T} = 0``.

    Used by the backward (occupancy) recursion, which flows right-to-left
    along the frame axis (mutual_information_cuda.cu:706-723 reversed).
    """
    c = jnp.flip(coeff, axis=axis)
    b = jnp.flip(bias, axis=axis)
    x = linear_scan(c, b, axis=axis)
    return jnp.flip(x, axis=axis)
