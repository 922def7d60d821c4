"""Ragged-utterance batching for transducer training.

XLA recompiles per input shape, so an input pipeline must feed a SMALL
set of static padded shapes.  The native planner (csrc/batching.cc) groups
utterances by length under a frame budget and quantizes the padded (T, S)
to a bucket grid; this module turns plans into padded device-ready batches
(features, feature_lens, symbols, symbol_lens) + the RNN-T boundary.

The reference ships no input pipeline (its tests hand-roll random batches);
this is a from-scratch runtime component.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..csrc import plan_batches_cpu


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    indices: np.ndarray  # utterance ids in this batch
    padded_frames: int
    padded_symbols: int


def collate_batch(
    features: Sequence[np.ndarray],  # each (T_i, F)
    symbols: Sequence[np.ndarray],  # each (S_i,)
    plan: BatchPlan,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad a planned batch to its static shape.

    Returns (feats [B,Tp,F], feat_lens [B], syms [B,Sp], sym_lens [B]).
    """
    B = len(plan.indices)
    F = features[plan.indices[0]].shape[1]
    Tp, Sp = plan.padded_frames, plan.padded_symbols
    feats = np.zeros((B, Tp, F), np.float32)
    feat_lens = np.zeros((B,), np.int32)
    syms = np.zeros((B, Sp), np.int32)
    sym_lens = np.zeros((B,), np.int32)
    for j, i in enumerate(plan.indices):
        f, y = features[i], symbols[i]
        feats[j, : len(f)] = f
        feat_lens[j] = len(f)
        syms[j, : len(y)] = y
        sym_lens[j] = len(y)
    return feats, feat_lens, syms, sym_lens


class RaggedBatcher:
    """Plans and yields padded static-shape batches from ragged utterances.

    Args:
      max_frames: total padded frames per batch (the memory budget).
      max_batch: max utterances per batch.
      quantum: padded lengths are rounded up to a multiple of this, bounding
        the number of distinct compiled shapes.
      pad_batch_to: if set, every batch is padded (with empty utterances of
        boundary [0,0,0,0]) to this utterance count — one static batch dim.
    """

    def __init__(
        self,
        max_frames: int = 30_000,
        max_batch: int = 64,
        quantum: int = 64,
        pad_batch_to: int | None = None,
    ):
        self.max_frames = max_frames
        # pad_batch_to promises ONE static batch dim, so it must also cap
        # the planner (otherwise dense batches would exceed it un-padded)
        self.max_batch = (
            max_batch if pad_batch_to is None else min(max_batch, pad_batch_to)
        )
        self.quantum = quantum
        self.pad_batch_to = pad_batch_to

    def plan(
        self, frame_lens: Sequence[int], sym_lens: Sequence[int]
    ) -> List[BatchPlan]:
        plans = plan_batches_cpu(
            np.asarray(frame_lens, np.int32),
            np.asarray(sym_lens, np.int32),
            self.max_frames,
            self.max_batch,
            self.quantum,
        )
        return [BatchPlan(idx, t, s) for idx, t, s in plans]

    def batches(
        self,
        features: Sequence[np.ndarray],
        symbols: Sequence[np.ndarray],
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        frame_lens = [len(f) for f in features]
        sym_lens = [len(s) for s in symbols]
        for plan in self.plan(frame_lens, sym_lens):
            feats, flens, syms, slens = collate_batch(features, symbols, plan)
            if self.pad_batch_to is not None and len(feats) < self.pad_batch_to:
                extra = self.pad_batch_to - len(feats)
                feats = np.concatenate(
                    [feats, np.zeros((extra,) + feats.shape[1:], feats.dtype)]
                )
                flens = np.concatenate([flens, np.zeros((extra,), np.int32)])
                syms = np.concatenate(
                    [syms, np.zeros((extra, syms.shape[1]), np.int32)]
                )
                slens = np.concatenate([slens, np.zeros((extra,), np.int32)])
            yield feats, flens, syms, slens


def prefetch(iterator, depth: int = 2):
    """Run an iterator on a background thread with a bounded queue.

    The standard host/device overlap for an input pipeline: while the
    device executes step N, the host collates (and feature-extracts, see
    ``fast_rnnt_tpu.csrc.fbank_cpu``) batch N+1.  ``depth`` bounds host
    memory; exceptions from the producer re-raise at the consumer.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()  # consumer abandoned: let the producer exit

    def _put(item) -> bool:
        # bounded-wait put so an abandoned generator can't block the
        # producer thread forever on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not _put(item):
                    return
            _put(_END)
        except BaseException as e:  # surfaced on the consumer side
            _put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # runs on GeneratorExit (early break) as well as exhaustion: signal
        # the producer and drain so it can observe the stop event promptly
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
