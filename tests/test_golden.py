"""Pin every implementation against golden vectors generated by explicit
path enumeration (tests/golden/generate_golden.py — float64, no DP
recursion anywhere in the derivation).

This closes the in-tree-oracle circularity: the four in-tree
implementations (numpy loop oracle, C++ csrc, XLA scan, GPU kernels)
all evaluate the same recursion; the golden file is derived from the
path-sum *definition* instead, so agreement here validates the recursion
itself, not just its transcriptions.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fast_rnnt_tpu as frt
from fast_rnnt_tpu.ops.lattice import get_rnnt_logprobs

from .oracle import mi_loop

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN_FILES = sorted(glob.glob(os.path.join(HERE, "*.npz")))
# the banded vectors encode band-MASKED semantics and have their own test
GENERIC_FILES = [p for p in GOLDEN_FILES if "banded" not in p]


def _load(path):
    z = np.load(path)
    return {k: z[k] for k in z.files}


@pytest.mark.parametrize("path", GENERIC_FILES, ids=os.path.basename)
def test_lattice_build_matches_golden(path):
    """get_rnnt_logprobs vs the first-principles f64 lattice."""
    g = _load(path)
    rnnt_type = "regular" if "regular" in path else "modified"
    px, py = get_rnnt_logprobs(
        jnp.asarray(g["lm"], jnp.float32),
        jnp.asarray(g["am"], jnp.float32),
        jnp.asarray(g["symbols"]),
        int(g["blank"]),
        rnnt_type,
        jnp.asarray(g["boundary"]),
    )
    np.testing.assert_allclose(np.asarray(px), g["px"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(py), g["py"], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("path", GENERIC_FILES, ids=os.path.basename)
def test_recursion_impls_match_golden(path):
    """Default path + XLA scan core vs path-enumeration scores/occupancies.

    The golden (px, py) are fed directly so this isolates the recursion;
    boundary masking inside the impls must reproduce the enumeration's
    walk limits.
    """
    g = _load(path)
    px = jnp.asarray(g["px"], jnp.float32)
    py = jnp.asarray(g["py"], jnp.float32)
    boundary = jnp.asarray(g["boundary"])
    for impl in (None, "xla"):
        scores, (gx, gy) = frt.mutual_information_recursion(
            px, py, boundary, calc_gradients=True, impl=impl
        )
        np.testing.assert_allclose(
            np.asarray(scores), g["scores"], rtol=1e-5, atol=1e-5,
            err_msg=f"impl={impl}",
        )
        np.testing.assert_allclose(
            np.asarray(gx), g["px_grad"], rtol=1e-4, atol=1e-5,
            err_msg=f"impl={impl}",
        )
        np.testing.assert_allclose(
            np.asarray(gy), g["py_grad"], rtol=1e-4, atol=1e-5,
            err_msg=f"impl={impl}",
        )


@pytest.mark.parametrize("path", GENERIC_FILES, ids=os.path.basename)
def test_numpy_loop_oracle_matches_golden(path):
    """The in-tree loop oracle itself is pinned to the enumeration."""
    g = _load(path)
    scores, gx, gy, _ = mi_loop(g["px"], g["py"], g["boundary"])
    np.testing.assert_allclose(scores, g["scores"], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(gx, g["px_grad"], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(gy, g["py_grad"], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize(
    "path", [p for p in GENERIC_FILES if "regular" in p], ids=os.path.basename
)
def test_cpp_oracle_matches_golden(path):
    """The native C++ oracle vs the enumeration (f32 tolerance)."""
    csrc = pytest.importorskip("fast_rnnt_tpu.csrc")
    g = _load(path)
    try:
        _, scores = csrc.mi_forward_cpu(
            g["px"].astype(np.float32), g["py"].astype(np.float32), g["boundary"]
        )
    except OSError:
        pytest.skip("no C++ toolchain available")
    np.testing.assert_allclose(scores, g["scores"], rtol=1e-5, atol=1e-5)


def test_golden_files_present():
    """Regeneration guard: the four committed vectors must exist."""
    names = {os.path.basename(p) for p in GOLDEN_FILES}
    assert {
        "config1_regular_full.npz",
        "config1_regular_ragged.npz",
        "config1_modified_full.npz",
        "config1_modified_ragged.npz",
    } <= names


def test_banded_recursion_matches_golden():
    """The in-kernel band masking (pruned stage 2) vs band-restricted path
    enumeration — the band semantics validated without the DP recursion
    anywhere in the derivation."""
    path = os.path.join(HERE, "config1_banded_K3.npz")
    g = _load(path)
    from fast_rnnt_tpu.ops.recursion import mutual_information_rows

    px_r = jnp.moveaxis(jnp.asarray(g["px"], jnp.float32), 1, 0)
    py_r = jnp.moveaxis(jnp.asarray(g["py"], jnp.float32), 1, 0)
    bnd = jnp.asarray(g["boundary"])
    lo = jnp.asarray(g["lo"])
    K = int(g["K"])
    for impl in (None, "xla"):
        scores, (gx, gy) = mutual_information_rows(
            px_r, py_r, bnd, lo=lo, s_range=K, calc_gradients=True, impl=impl
        )
        np.testing.assert_allclose(
            np.asarray(scores), g["scores"], rtol=1e-5, atol=1e-5,
            err_msg=f"impl={impl}",
        )
        np.testing.assert_allclose(
            np.asarray(jnp.moveaxis(gx, 0, 1)), g["px_grad"],
            rtol=1e-4, atol=1e-5, err_msg=f"impl={impl}",
        )
        np.testing.assert_allclose(
            np.asarray(jnp.moveaxis(gy, 0, 1)), g["py_grad"],
            rtol=1e-4, atol=1e-5, err_msg=f"impl={impl}",
        )
