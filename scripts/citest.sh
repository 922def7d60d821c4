#!/bin/sh
# Run the test suite in time-bounded chunks for CI runners with strict
# per-command timeouts (each chunk stays well under ~6 min cold on a
# 1-core box).  `python -m pytest tests/ -q` runs the same default tier
# in one go (~11 min); add -m "" for the full tier incl. slow configs.
#
# Chunks 1-2 name the slow compile-heavy files explicitly; chunk 3 runs
# EVERYTHING ELSE under tests/ via --ignore, so a newly added test file
# (or one dropped from the explicit lists) is always collected — a gate
# can never silently fall out of CI again (a gate once went dead because
# this script hard-listed files and never ran it).
set -e
M="${1:-not slow}"
CHUNK1="tests/test_recursion.py tests/test_golden.py tests/test_recursion_core.py tests/test_alignment.py"
CHUNK2="tests/test_lattice.py tests/test_losses.py tests/test_pruning.py tests/test_edge_cases.py tests/test_serving.py"
python -m pytest $CHUNK1 -q -m "$M"
python -m pytest $CHUNK2 -q -m "$M"
IGNORES=""
for f in $CHUNK1 $CHUNK2; do IGNORES="$IGNORES --ignore=$f"; done
python -m pytest tests/ $IGNORES -q -m "$M"
