"""Stateless-resume LM data loaders (synthetic + memmapped token shards).

A copy of ``orion_tpu/data/loader.py`` (which imports jax): the same
(seed, step) -> batch streams as numpy arrays, byte for byte —
``tests/test_torch_train.py`` holds them against the original. Every
loader is deterministic in (seed, step) GLOBALLY: a host's shard is a row
slice of the same global batch, so the stream does not depend on the
process count. ``batch_at(step)`` returns this host's rows; the trainer
moves them to its device.

The memmap path reads flat token files (uint16/uint32) with the port's
copy of the JAX package's C++ reader (``data/native``) when
``data.use_native_loader`` is set, and with numpy otherwise, or when the
reader cannot be built (logged; ``MemmapLoader.reader_kind`` says which).
Both return the same bytes.
"""

from __future__ import annotations

import abc
import logging
from typing import Mapping, Optional

import numpy as np

from orion_tpu_torch.config import DataConfig

Batch = Mapping[str, np.ndarray]

log = logging.getLogger("orion_tpu_torch.data")

# Data-stream format version, the JAX package's (``orion_tpu/data/loader.py``)
# and recorded in every checkpoint manifest. Bump whenever the (seed, step)
# -> batch mapping changes, because the stream is otherwise silent about it:
# resume replays a different token order with no error. History:
#   1 — per-process streams (seed included process_index).
#   2 — global (seed, step)-deterministic batch sliced per host.
STREAM_FORMAT = 2

# Tally of pack_rows' bounded token loss (see its docstring).
pack_stats = {"dropped_tokens": 0}


class Loader(abc.ABC):
    """Per-host view of a deterministic global batch stream.

    The stream is a pure function of ``(shuffle_seed, data_step)`` where
    ``data_step = step + offset``: the ``offset`` cursor (default 0) is the
    loader's only mutable state, serialized into every checkpoint manifest
    (``state_dict``/``load_state_dict``) so resume replays the identical
    token order bitwise. ``skip_batches`` advances it without advancing the
    optimizer step: the auto-rollback path uses it to fast-forward past a
    poisoned batch window.
    """

    def __init__(self, cfg: DataConfig, process_index: int, process_count: int):
        if cfg.batch_size % process_count:
            raise ValueError(
                f"global batch {cfg.batch_size} not divisible by "
                f"{process_count} processes"
            )
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        self.host_batch = cfg.batch_size // process_count
        self.offset = 0
        if process_index == 0:
            log.info("data stream format v%d (seed=%s): resuming a "
                     "checkpoint written under an older format replays a "
                     "different token order (see loader.STREAM_FORMAT)",
                     STREAM_FORMAT, cfg.shuffle_seed)

    @abc.abstractmethod
    def batch_at(self, step: int) -> Batch:
        """Host-local shard: inputs/targets [host_batch, seq_len] int32."""

    def data_step(self, step: int) -> int:
        """The stream index a trainer step maps to (cursor applied)."""
        return step + self.offset

    def skip_batches(self, n: int) -> None:
        """Advance the cursor by ``n`` global batches; it never rewinds."""
        if n < 0:
            raise ValueError(f"skip_batches({n}): cursor never rewinds")
        self.offset += n

    def state_dict(self) -> dict:
        """The cursor as the checkpoint manifest's ``extra["loader"]``."""
        return {
            "version": 1,
            "offset": self.offset,
            "stream_format": STREAM_FORMAT,
            "shuffle_seed": self.cfg.shuffle_seed,
        }

    def load_state_dict(self, state: Mapping) -> None:
        fmt = state.get("stream_format")
        if fmt is not None and fmt != STREAM_FORMAT:
            log.warning(
                "loader state was written under data-stream format %s but "
                "this build uses format %d: resume continues on a "
                "DIFFERENT token order", fmt, STREAM_FORMAT,
            )
        seed = state.get("shuffle_seed")
        if seed is not None and seed != self.cfg.shuffle_seed:
            log.warning(
                "loader state was written under shuffle_seed=%s but this "
                "run uses %s: resume continues on a different token order",
                seed, self.cfg.shuffle_seed,
            )
        self.offset = int(state.get("offset", 0))


def pack_rows(
    docs_per_row: list[list[np.ndarray]],
    seq_len: int,
    carry_group: Optional[int] = None,
) -> Batch:
    """Pack variable-length documents into fixed [B, S] packed batches.

    Each document contributes its (input, target) pairs independently —
    targets never cross a document boundary, attention is confined to the
    document via ``segment_ids``, RoPE restarts via ``positions``, and the
    padding tail is excluded via ``loss_mask``. Segment id 0 is padding
    (the flash kernels' ``seg_pad_zero`` convention).

    A document that crosses a row boundary is split, not truncated: the
    untrained remainder carries over to the front of the next row, within
    groups of ``carry_group`` rows (the carry resets at every multiple,
    dropping that overhang and counting it in ``pack_stats``). None =
    carry across all rows.
    """
    B = len(docs_per_row)
    inputs = np.zeros((B, seq_len), np.int32)
    targets = np.zeros((B, seq_len), np.int32)
    segments = np.zeros((B, seq_len), np.int32)
    positions = np.zeros((B, seq_len), np.int32)
    mask = np.zeros((B, seq_len), np.float32)
    carry: list[np.ndarray] = []  # docs (or tails) displaced into the next row
    for b, docs in enumerate(docs_per_row):
        if carry_group is not None and b % carry_group == 0:
            if carry:
                dropped = sum(max(len(d) - 1, 0) for d in carry)
                pack_stats["dropped_tokens"] += dropped
                log.debug("pack_rows: dropped %d tokens at carry-group "
                          "boundary (row %d)", dropped, b)
            carry = []
        at, seg = 0, 0
        queue, carry = carry + list(docs), []
        for doc in queue:
            doc = np.asarray(doc)
            if len(doc) < 2:
                continue       # degenerate doc: skip, keep packing the rest
            if at >= seq_len:
                carry.append(doc)  # row already full: displace whole doc
                continue
            n = min(len(doc) - 1, seq_len - at)  # pairs, not tokens
            seg += 1
            inputs[b, at : at + n] = doc[:n]
            targets[b, at : at + n] = doc[1 : n + 1]
            segments[b, at : at + n] = seg
            positions[b, at : at + n] = np.arange(n)
            mask[b, at : at + n] = 1.0
            at += n
            if n < len(doc) - 1:
                # Truncated mid-document: resume at token n so the next row
                # trains the pair (doc[n] -> doc[n+1]) and nothing is lost.
                carry.append(doc[n:])
    return {
        "inputs": inputs,
        "targets": targets,
        "segment_ids": segments,
        "positions": positions,
        "loss_mask": mask,
    }


class SyntheticLoader(Loader):
    """Deterministic pseudo-random tokens with a learnable structure: a
    noisy modular progression, so a real model drives the loss well below
    log(vocab) without any dataset on disk."""

    def __init__(self, cfg: DataConfig, process_index: int, process_count: int,
                 vocab_size: int):
        super().__init__(cfg, process_index, process_count)
        self.vocab_size = vocab_size

    def _doc(self, rng, length: int) -> np.ndarray:
        start = rng.integers(0, self.vocab_size)
        ramp = np.arange(length, dtype=np.int64)
        noise = rng.integers(0, 2, size=length)
        return ((start + 3 * ramp + noise) % self.vocab_size).astype(np.int32)

    def _slice(self, batch: Batch) -> Batch:
        lo = self.process_index * self.host_batch
        return {k: v[lo : lo + self.host_batch] for k, v in batch.items()}

    def batch_at(self, step: int) -> Batch:
        # The GLOBAL batch (seeded by the cursor-adjusted step only), then
        # this host's rows.
        gb, s = self.cfg.batch_size, self.cfg.seq_len
        rng = np.random.default_rng((self.cfg.shuffle_seed, self.data_step(step)))
        if self.cfg.packed:
            rows = []
            for _ in range(gb):
                docs, filled = [], 0
                while filled < s:
                    length = int(rng.integers(8, max(9, s // 2)))
                    docs.append(self._doc(rng, length + 1))
                    filled += length
                rows.append(docs)
            return self._slice(
                pack_rows(rows, s, carry_group=self.cfg.pack_carry_group)
            )
        start = rng.integers(0, self.vocab_size, size=(gb, 1))
        ramp = np.arange(s + 1, dtype=np.int64)[None, :]
        noise = rng.integers(0, 2, size=(gb, s + 1))
        seq = (start + 3 * ramp + noise) % self.vocab_size
        seq = seq.astype(np.int32)
        return self._slice({"inputs": seq[:, :-1], "targets": seq[:, 1:]})


class MemmapLoader(Loader):
    """Flat binary token file; samples length-(S+1) windows at
    pseudo-random but step-indexed offsets, so every (seed, step) pair maps
    to a fixed set of windows across restarts."""

    def __init__(self, cfg: DataConfig, process_index: int, process_count: int,
                 vocab_size: int):
        super().__init__(cfg, process_index, process_count)
        if cfg.path is None:
            raise ValueError("memmap loader needs data.path")
        self.reader = _open_reader(cfg)
        self.reader_kind = "numpy" if isinstance(self.reader, _NumpyReader) else "native"
        self.n_tokens = len(self.reader)
        need = cfg.seq_len + 1
        if self.n_tokens < need * cfg.batch_size:
            raise ValueError(
                f"token file too small: {self.n_tokens} tokens for "
                f"batch {cfg.batch_size} x seq {cfg.seq_len}"
            )
        self.n_windows = self.n_tokens - need + 1

    def _offsets_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.cfg.shuffle_seed, self.data_step(step))
        )
        return rng.integers(0, self.n_windows, size=self.cfg.batch_size)

    def batch_at(self, step: int) -> Batch:
        s = self.cfg.seq_len
        lo = self.process_index * self.host_batch
        hi = lo + self.host_batch
        if self.cfg.packed:
            # Carry crosses rows only within fixed global groups, so this
            # host reads the group-aligned row range covering its slice.
            G = self.cfg.pack_carry_group
            g0 = (lo // G) * G
            g1 = min(-(-hi // G) * G, self.cfg.batch_size)
            fetch = slice(g0, g1)
        else:
            fetch = slice(lo, hi)
        rows = self.reader.gather(self._offsets_at(step)[fetch], s + 1)
        if hasattr(self.reader, "prefetch"):
            # Page in the next step's windows while this step trains.
            self.reader.prefetch(self._offsets_at(step + 1)[fetch], s + 1)
        rows = rows.astype(np.int32)
        if self.cfg.packed:
            eos = self.cfg.eos_token_id
            docs_per_row = []
            for row in rows:
                cuts = np.flatnonzero(row == eos)
                bounds = [0, *(int(c) + 1 for c in cuts), len(row)]
                docs = [
                    row[a:b]
                    for a, b in zip(bounds[:-1], bounds[1:])
                    if b - a >= 2
                ]
                # No span of >= 2 tokens (e.g. a run of EOS): the row stays
                # fully masked rather than training across EOS boundaries.
                docs_per_row.append(docs)
            packed = pack_rows(docs_per_row, s, carry_group=G)
            return {k: v[lo - g0 : hi - g0] for k, v in packed.items()}
        return {"inputs": rows[:, :-1], "targets": rows[:, 1:]}


class _NumpyReader:
    def __init__(self, path: str, dtype: np.dtype):
        self.mm = np.memmap(path, dtype=dtype, mode="r")

    def __len__(self) -> int:
        return len(self.mm)

    def gather(self, offsets: np.ndarray, width: int) -> np.ndarray:
        return np.stack([np.asarray(self.mm[o : o + width]) for o in offsets])


def _token_dtype(path: str) -> np.dtype:
    # .u16/.u32 suffix convention; default uint16 (vocab < 65536).
    if path.endswith(".u32") or path.endswith(".bin32"):
        return np.dtype(np.uint32)
    return np.dtype(np.uint16)


def _open_reader(cfg: DataConfig):
    """The native reader when ``data.use_native_loader`` is set and it
    builds and opens, else numpy (the JAX package's fallback, logged)."""
    dtype = _token_dtype(cfg.path)
    if cfg.use_native_loader:
        try:
            from orion_tpu_torch.data.native import NativeReader

            return NativeReader(cfg.path, dtype)
        except (ImportError, OSError) as e:
            log.warning("native token reader unavailable (%s); reading %s with numpy",
                        e, cfg.path)
    return _NumpyReader(cfg.path, dtype)


def make_loader(
    cfg: DataConfig, vocab_size: int, process_index: int = 0, process_count: int = 1
) -> Loader:
    if cfg.source == "synthetic":
        return SyntheticLoader(cfg, process_index, process_count, vocab_size)
    if cfg.source == "memmap":
        return MemmapLoader(cfg, process_index, process_count, vocab_size)
    raise ValueError(f"unknown data source {cfg.source!r}")
