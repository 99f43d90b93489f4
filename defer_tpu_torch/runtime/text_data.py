"""Packed token pipeline for LM training (the port's own copy of
`defer_tpu/runtime/text_data.py`, numpy only: the same documents and
seed give the same windows).

Variable-length documents pack into the fixed [num_microbatches, batch,
seq] blocks the LM train step consumes
(parallel/train.py::make_lm_train_step):

  * PACKING, not padding: documents concatenate into one token stream
    separated by eos, and fixed windows are cut from it, so every
    position is a real training target and shapes stay fixed;
  * the host side is pure numpy (runtime/data.py's prefetch_to_device
    moves blocks to the card); the device never sees ragged data;
  * deterministic: a seeded shuffle of document order, so a run is
    reproducible and a resumed run can skip consumed steps.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import numpy as np


def pack_documents(
    docs: Iterable[Sequence[int]],
    seq_len: int,
    *,
    eos_id: int,
    drop_remainder: bool = True,
) -> Iterator[np.ndarray]:
    """Concatenate token documents (eos-separated) into a stream and
    cut fixed [seq_len] windows from it.

    Every document contributes `len(doc) + 1` stream tokens (its eos
    separator teaches the model where documents end). The final
    partial window is dropped by default (a padded tail would need a
    loss mask the packed layout exists to avoid).
    """
    if seq_len < 2:
        raise ValueError(f"seq_len={seq_len}: need at least 2 tokens")
    buf = np.empty((0,), np.int32)
    for doc in docs:
        arr = np.asarray(doc, np.int32)
        if arr.ndim != 1:
            raise ValueError(f"documents must be 1-D, got {arr.shape}")
        buf = np.concatenate([buf, arr, np.asarray([eos_id], np.int32)])
        while len(buf) >= seq_len:
            yield buf[:seq_len].copy()
            buf = buf[seq_len:]
    if len(buf) and not drop_remainder:
        pad = np.full((seq_len - len(buf),), eos_id, np.int32)
        yield np.concatenate([buf, pad])


def lm_batches(
    docs: Sequence[Sequence[int]],
    *,
    seq_len: int,
    batch: int,
    num_microbatches: int,
    eos_id: int,
    seed: int = 0,
    epochs: int = 1,
) -> Iterator[np.ndarray]:
    """[num_microbatches, batch, seq_len] int32 blocks for the LM
    train step, from a document set: seeded document shuffle per
    epoch, packed stream, fixed-shape blocks (ragged tails dropped —
    static shapes are what keep the step compiled once)."""
    if not docs:
        raise ValueError("no documents")
    need = num_microbatches * batch
    # One epoch must fill at least one block — a too-small corpus
    # would otherwise yield NOTHING and a training loop would
    # "complete" having trained zero steps.
    rows_per_epoch = token_count(docs) // seq_len
    if rows_per_epoch < need:
        raise ValueError(
            f"corpus packs to {rows_per_epoch} rows of {seq_len} per "
            f"epoch but one [M={num_microbatches}, B={batch}] block "
            f"needs {need} — add documents or shrink the block"
        )
    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        order = rng.permutation(len(docs))
        rows: list[np.ndarray] = []
        for row in pack_documents(
            (docs[i] for i in order), seq_len, eos_id=eos_id
        ):
            rows.append(row)
            if len(rows) == need:
                yield (
                    np.stack(rows)
                    .reshape(num_microbatches, batch, seq_len)
                )
                rows = []


def token_count(docs: Sequence[Sequence[int]]) -> int:
    """Stream length the packer will produce (docs + eos separators) —
    for sizing epochs/steps up front."""
    return sum(len(d) + 1 for d in docs)
