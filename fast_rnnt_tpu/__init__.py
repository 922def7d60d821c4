"""fast_rnnt_tpu — a pruned RNN-T loss framework in JAX.

A from-scratch re-design (not a port) of the capabilities of
Samsung/tf-fast-rnnt: the pruned RNN-T loss of the Pruned RNN-T paper
(arXiv:2206.13236), built on JAX/XLA (log-semiring associative scans, a
CUDA wavefront kernel for the recursion on GPUs, jax.sharding), lifting
the reference's two declared limitations (GPU-only; mandatory boundary).

Public API parity with the reference package
(tf_fast_rnnt/python/tf_fast_rnnt/__init__.py:24-33), plus extensions
(parallel/, models/).
"""

from .ops.alignment import viterbi_alignment, viterbi_scores
from .ops.lattice import (
    fix_for_boundary,
    get_rnnt_logprobs,
    get_rnnt_logprobs_joint,
    get_rnnt_logprobs_pruned,
    get_rnnt_logprobs_pruned_simple,
    get_rnnt_logprobs_smoothed,
    roll_by_shifts,
    set_matmul_precision,
)
from .ops.losses import (
    rnnt_loss,
    rnnt_loss_chunked,
    rnnt_loss_pruned,
    rnnt_loss_pruned_simple,
    rnnt_loss_simple,
    rnnt_loss_simple_pruned,
    rnnt_loss_smoothed,
    rnnt_loss_smoothed_pruned,
)
from .ops.pruning import (
    adjust_pruning_lower_bound,
    do_rnnt_pruning,
    get_rnnt_prune_ranges,
    get_rnnt_prune_ranges_rows,
)
from .ops.recursion import (
    cummin,
    monotonic_lower_bound,
    mutual_information_recursion,
    mutual_information_rows,
)

__version__ = "0.1.0"

__all__ = [
    "__version__",
    # recursion core
    "mutual_information_recursion",
    "mutual_information_rows",
    "cummin",
    "monotonic_lower_bound",
    # lattice construction
    "fix_for_boundary",
    "get_rnnt_logprobs",
    "get_rnnt_logprobs_joint",
    "get_rnnt_logprobs_pruned",
    "get_rnnt_logprobs_pruned_simple",
    "get_rnnt_logprobs_smoothed",
    "roll_by_shifts",
    "set_matmul_precision",
    # pruning pipeline
    "adjust_pruning_lower_bound",
    "get_rnnt_prune_ranges",
    "get_rnnt_prune_ranges_rows",
    "do_rnnt_pruning",
    # losses
    "rnnt_loss_simple",
    "rnnt_loss_smoothed",
    "rnnt_loss",
    "rnnt_loss_chunked",
    "rnnt_loss_pruned",
    "rnnt_loss_pruned_simple",
    "rnnt_loss_simple_pruned",
    "rnnt_loss_smoothed_pruned",
    "viterbi_scores",
    "viterbi_alignment",
]
