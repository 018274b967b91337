"""Atomic, verifiable checkpoints in the JAX package's on-disk format.

The port's copy of ``orion_tpu/ckpt/checkpoint.py`` for one process, over
trees of torch tensors. A checkpoint either package writes restores in the
other, and the two write the same bytes for the same state:

  - **Layout**: ``step_NNNNNNNN/`` holds one raw little-endian file per
    leaf, ``arr_{i:05d}.bin``, and ``manifest.json`` (``CKPT_FORMAT``, the
    step, the data-stream format, the caller's ``extra`` dict, and per
    leaf its dtype, shape, sharding and the shard files with their byte
    count and CRC-32). Leaves are keyed by ``jax.tree_util.keystr`` paths
    (``['opt']['mu']['embed']['tokens']``) and numbered in
    ``jax.tree_util``'s order, dict keys sorted at every level; that is
    the order ``_flatten_with_keys`` walks. bfloat16 travels as its 16-bit
    pattern under the dtype name ``"bfloat16"``, so neither side needs
    ``ml_dtypes``.
  - **Atomic commit**: every file is written and fsynced into
    ``.tmp-step_N``, then the manifest, then the directory, and only then
    is it renamed to ``step_N``. An overwrite moves the committed directory
    aside as ``step_N.replaced`` first. A crash leaves either the previous
    checkpoints or a ``.tmp-*`` directory that the next manager sweeps.
  - **Verifiable restore**: the newest checkpoint is validated (manifest,
    leaf set, shapes, dtypes, file sizes and, with
    ``checkpoint.verify_restore``, every CRC); a corrupt one is moved under
    ``quarantine/step_N-<reason>`` with a typed ``CorruptCheckpoint``
    reason and restore falls back to the next newest.
  - **Async saves** run the file I/O on one writer thread over host copies
    taken at ``save()``; the worker stamps the stream format after each
    commit, and ``wait()`` raises the first failed save.

One process writes every leaf whole. On a mesh of processes (one a
device; the trainer passes ``CheckpointShards``: each leaf's spec, the
mesh's sizes and this process's coordinates) the save follows the JAX
package's multi-process protocol: process 0 writes the replicated leaves
whole; each process writes its own block of every sharded leaf (the first
replica of each block, as JAX writes ``replica_id`` 0) as
``arr_NNNNN.p{process}.s{j}.bin`` with the block's global index; the
other processes publish their shard entries as manifest fragments; after
a barrier process 0 merges them into the manifest and commits; a second
barrier follows the commit. Async saves are downgraded to synchronous
ones there (the barriers must run on the main thread). Restore reads the
region this process needs (its block in the target layout, or the whole
leaf) from whatever shards were recorded, so a checkpoint saved at one
layout restores at another, and in either package. Which step is the
newest intact one is decided by every process together
(``runtime.distributed.agree_on_steps`` / ``agree_all``): the checksum
pass is divided across the processes by file name, and a step any
process finds corrupt is abandoned by all (``peer_corrupt`` where its own
portion was intact).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import re
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from orion_tpu_torch.config import CheckpointConfig
from orion_tpu_torch.data.loader import STREAM_FORMAT
from orion_tpu_torch.models.convert import jax_leaves_with_path
from orion_tpu_torch.parallel.sharding import (
    block_index,
    is_sharded,
    parts,
    spec_desc,
    writes_block,
)
from orion_tpu_torch.runtime import distributed as rt

log = logging.getLogger("orion_tpu_torch.ckpt")

CKPT_FORMAT = 1
_MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"^step_(\d{8})$")
_TMP_PREFIX = ".tmp-"
_QUARANTINE = "quarantine"


class CorruptCheckpoint(RuntimeError):
    """A committed checkpoint failed validation, with a typed ``reason``:

    - ``missing_manifest`` — the directory has no manifest.json (torn
      rename / partial deletion).
    - ``bad_manifest``     — manifest present but unparseable or not a
      supported format version.
    - ``leaf_mismatch``    — the manifest's leaf set or a leaf's
      shape/dtype does not match the restore target's schema.
    - ``missing_array``    — a manifest-listed array file is absent, or
      the recorded shards do not cover the full array.
    - ``truncated_array``  — an array file is shorter than the manifest
      says (torn write / partial flush).
    - ``bad_checksum``     — file length right, CRC-32 wrong (bit rot /
      post-rename data loss / injected partial_write).
    - ``peer_corrupt``     — this process's portion is intact but another
      process voted its portion corrupt, so the step is unusable on every
      process.
    """

    def __init__(self, step: int, reason: str, detail: str = ""):
        self.step = step
        self.reason = reason
        self.detail = detail
        msg = f"checkpoint step {step} corrupt ({reason})"
        super().__init__(msg + (f": {detail}" if detail else ""))


# -- trees in jax.tree_util's order -------------------------------------------


def _keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


def _flatten_with_keys(tree: Any) -> list[tuple[str, Any]]:
    """(keystr, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    lists by index."""
    return [(_keystr(path), leaf) for path, leaf in jax_leaves_with_path(tree)]


def _rebuild(tree: Any, by_key: dict, path: tuple = ()) -> Any:
    """A tree shaped like ``tree`` (its own key order) whose leaves are
    ``by_key[keystr]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, by_key, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, by_key, path + (i,)) for i, v in enumerate(tree)]
    return by_key[_keystr(path)]


def _dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype ("float32", "bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a saved dtype's bytes (bfloat16 as its
    16-bit pattern)."""
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


def _host_array(leaf: Any, copy: bool) -> np.ndarray:
    """The leaf's bytes on the host. A card's tensor comes back through a
    device-to-host copy, which is the snapshot; a CPU tensor is cloned when
    ``copy`` (async saves: the optimizer updates in place, and a view would
    capture the next step's bytes)."""
    t = torch.as_tensor(leaf).detach()
    if t.device.type != "cpu":
        t = t.cpu()
    elif copy:
        t = t.clone()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()




@dataclasses.dataclass(frozen=True)
class CheckpointShards:
    """A process's place in a sharded save: ``specs`` maps each leaf's path
    (a tuple of keys, as ``jax_leaves_with_path`` gives it) to its spec in
    the checkpoint layout (``parallel.sharding``; () for a replicated
    scalar): the blocks saved. ``held`` maps the paths whose tensors hold
    more than the saved block to the spec of what they hold (a ZeRO-1
    update over stacked layers: every dp rank holds all layers, each saves
    its block of them); ``sizes`` the mesh's axis sizes and ``coords``
    this process's coordinates."""

    specs: dict
    sizes: dict
    coords: dict
    held: dict = dataclasses.field(default_factory=dict)

    def by_key(self) -> dict:
        """keystr -> (saved spec, held spec)."""
        return {_keystr(path): (tuple(spec), tuple(self.held.get(path, spec)))
                for path, spec in self.specs.items()}


def _norm_index(index: Optional[list], shape) -> list:
    """A shard index as [[start, stop], ...] (None = the whole array)."""
    if index is None:
        return [[0, int(d)] for d in shape]
    return [[int(a), int(b)] for a, b in index]


def _extent(index: list) -> tuple:
    return tuple(stop - start for start, stop in index)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # some filesystems refuse directory fsync; best effort
        pass


class CheckpointManager:
    """Atomic checkpoint manager (see the module docstring).

    ``save``/``latest_step``/``restore_latest``/``wait``/``close`` as in
    the JAX package; ``save(..., extra=...)`` carries host metadata,
    ``last_restore_extra``/``last_restore_step``/``quarantined`` report the
    last restore, and an optional ``fault_injector``'s ``partial_write``
    specs tear a commit for recovery tests.
    """

    def __init__(
        self,
        directory: str,
        cfg: CheckpointConfig,
        fault_injector: Optional[Any] = None,
        shards: Optional[CheckpointShards] = None,
    ):
        self.cfg = cfg
        self._dir = directory
        self._injector = fault_injector
        self._shards = shards
        self._spec_of = shards.by_key() if shards is not None else {}
        self._process, self._count = rt.process_index(), rt.process_count()
        # A multi-process commit barriers between the processes (write ->
        # merge -> rename); on the writer thread, beside the main thread's
        # collectives, that would deadlock the ranks, so it runs in line.
        self._async = cfg.async_save and self._count == 1
        if cfg.async_save and not self._async:
            log.info("async_save downgraded to sync: multi-process commits "
                     "barrier across processes and must run on the main thread")
        self._queue: queue.Queue = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._inflight: set[int] = set()
        self._stamp_pending = False
        self.save_error: Optional[BaseException] = None
        # Restore report (filled by restore_latest):
        self.last_restore_step: Optional[int] = None
        self.last_restore_extra: dict = {}
        self.quarantined: list[tuple[int, str]] = []
        os.makedirs(directory, exist_ok=True)
        self._sweep_torn_tmp()

    # -- directory layout --------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step:08d}")

    def _committed_steps(self) -> list[int]:
        try:
            names = os.listdir(self._dir)
        except OSError:
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_RE.match, names) if m)

    def _sweep_torn_tmp(self) -> None:
        """Resolve crash leftovers. ``.tmp-*`` dirs were never renamed, so
        never restorable: sweeping them leaves the committed checkpoints as
        the restore set. ``step_N.replaced`` dirs are the aside copy of a
        two-phase overwrite: restored if the crash landed before the new
        dir, discarded if after."""
        for name in os.listdir(self._dir):
            path = os.path.join(self._dir, name)
            try:
                if name.startswith(_TMP_PREFIX):
                    log.warning(
                        "sweeping torn checkpoint save %s (crash mid-save; "
                        "previous committed checkpoints are intact)", name,
                    )
                    shutil.rmtree(path, ignore_errors=True)
                elif name.endswith(".replaced"):
                    final = path[: -len(".replaced")]
                    if os.path.isdir(final):
                        shutil.rmtree(path, ignore_errors=True)
                    else:
                        log.warning(
                            "restoring %s from its overwrite-aside copy "
                            "(crash mid-replace)", os.path.basename(final),
                        )
                        os.rename(path, final)
            except OSError as e:   # another manager already resolved it
                log.warning("sweep of %s raced: %s", name, e)

    # -- stream-format stamp (sidecar) ---------------------------------------

    @property
    def _fmt_path(self) -> str:
        return os.path.join(self._dir, "stream_format.json")

    def _stamp_stream_format(self) -> None:
        if self._process != 0:
            return
        try:
            with open(self._fmt_path, "w") as f:
                json.dump({"stream_format": STREAM_FORMAT}, f)
        except OSError as e:          # non-fatal: stamping is advisory
            log.warning("could not stamp stream format: %s", e)

    def _check_stream_format(self, manifest: dict) -> None:
        saved = manifest.get("stream_format")
        if saved != STREAM_FORMAT:
            log.warning(
                "checkpoint was written under data-stream format %s but "
                "this build uses format %d: resume will train on a "
                "different token order than the original run", saved,
                STREAM_FORMAT,
            )

    # -- save ---------------------------------------------------------------

    def save(
        self,
        step: int,
        state: Any,
        *,
        force: bool = False,
        extra: Optional[dict] = None,
        overwrite: bool = False,
    ) -> bool:
        """Save if the step matches the save interval (or ``force``).

        ``state`` is the tree to save, or a function that builds it, called
        only when the step is saved. The device-to-host copy happens here;
        with ``cfg.async_save`` the file I/O and the atomic commit run on
        the writer thread over those host copies, so the caller may update
        the state at once. ``extra`` is a JSON-able dict stored in the
        manifest (loader cursor, anomaly-guard EMA, ...). ``overwrite``
        replaces a committed step: the auto-rollback replay uses it, since
        the checkpoints past the rollback point captured an abandoned
        trajectory.
        """
        if not (force or step % self.cfg.save_interval_steps == 0):
            return False
        if step in self._inflight:
            return False
        if not overwrite and step in self._committed_steps():
            return False
        if callable(state):
            state = state()
        job = self._capture(step, state, extra, copy=self._async)
        if self._async:
            self._inflight.add(step)
            self._stamp_pending = True   # cleared by the worker post-commit
            self._ensure_worker()
            self._queue.put(job)
            log.info("checkpoint queued at step %d (async)", step)
        else:
            self._commit(*job)
            log.info("checkpoint saved at step %d", step)
        return True

    def _capture(self, step: int, state: Any, extra: Optional[dict], copy: bool) -> tuple:
        """The host copies to write: per leaf (key, whole shape, dtype, the
        sharding record, [(global index or None, array), ...]). One process
        writes every leaf whole; on a mesh process 0 writes the replicated
        leaves and each process the blocks it is the first replica of."""
        leaves = []
        for key, leaf in _flatten_with_keys(state):
            dtype = _dtype_name(leaf.dtype)
            if self._shards is None and self._count == 1:
                leaves.append((key, tuple(leaf.shape), dtype, [],
                               [(None, _host_array(leaf, copy))]))
                continue
            spec, held = self._spec_of.get(key, ((), ()))
            shape = tuple(leaf.shape)
            if not is_sharded(spec):
                shards = [(None, _host_array(leaf, copy))] if self._process == 0 else []
            else:
                sz, at = self._shards.sizes, self._shards.coords
                shape = tuple(n * parts(held, d, sz) for d, n in enumerate(leaf.shape))
                shards = []
                if writes_block(spec, sz, at):
                    index = block_index(shape, spec, sz, at)
                    have = block_index(shape, held, sz, at)
                    block = leaf[tuple(slice(a - h, b - h)
                                       for (a, b), (h, _) in zip(index, have))]
                    shards = [(index, _host_array(block, copy))]
            leaves.append((key, shape, dtype, spec_desc(spec), shards))
        return step, leaves, dict(extra or {})

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._drain, name="orion-ckpt-writer", daemon=True
            )
            self._worker.start()

    def _drain(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                self._commit(*job)
                log.info("checkpoint committed at step %d (async)", job[0])
            # Every failure of the writer thread parks in save_error, which
            # wait() re-raises on the caller's thread.
            except BaseException as e:  # noqa: BLE001
                self.save_error = e
                log.exception("async checkpoint save failed")
            finally:
                if job is not None:
                    # Always release the step: a failed commit left in
                    # _inflight would make every later save of that step
                    # (an emergency save too) silently no-op.
                    self._inflight.discard(job[0])
                self._queue.task_done()

    def _commit(self, step: int, leaves: list, extra: dict) -> None:
        """Write + fsync + manifest + atomic rename (the whole protocol); on
        a mesh with the fragment merge between two barriers."""
        tmp = os.path.join(self._dir, f"{_TMP_PREFIX}step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        written: list[str] = []
        entries: dict[str, dict] = {}
        for i, (key, shape, dtype, desc, shards) in enumerate(leaves):
            shard_entries = []
            for j, (index, arr) in enumerate(shards):
                fname = (f"arr_{i:05d}.bin" if index is None
                         else f"arr_{i:05d}.p{self._process}.s{j}.bin")
                data = np.ascontiguousarray(arr).tobytes()
                path = os.path.join(tmp, fname)
                with open(path, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                written.append(path)
                shard_entries.append({
                    "file": fname,
                    "index": index,
                    "nbytes": len(data),
                    "crc32": zlib.crc32(data),
                })
            # One process records what a one-device JAX run does:
            # PartitionSpec(), the whole array in one place. Restore never
            # reads the sharding record.
            entries[key] = {"dtype": dtype, "shape": list(shape), "sharding": desc,
                            "shards": shard_entries}
        if self._injector is not None and written:
            spec = self._injector.take("partial_write", step, "ckpt")
            if spec is not None:
                # Tear the largest file AFTER its checksum landed in the
                # entries: data lost post-commit, so the manifest disagrees
                # with the bytes and restore must notice.
                victim = max(written, key=os.path.getsize)
                size = os.path.getsize(victim)
                with open(victim, "r+b") as f:
                    f.truncate(max(size // 2, 1))
                log.warning(
                    "fault injection: tore checkpoint file %s at step %d",
                    os.path.basename(victim), step,
                )
        if self._process != 0:
            # The other processes publish their shard entries as a
            # fragment; process 0 merges them after the barrier.
            with open(os.path.join(tmp, f"manifest.p{self._process}.json"), "w") as f:
                json.dump(entries, f)
                f.flush()
                os.fsync(f.fileno())
        _fsync_dir(tmp)
        rt.barrier(f"ckpt_written_{step}")
        if self._process == 0:
            manifest = {
                "format": CKPT_FORMAT,
                "step": step,
                "stream_format": STREAM_FORMAT,
                "extra": extra,
                "leaves": self._merge_fragments(tmp, entries),
            }
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            dest = self._step_dir(step)
            replaced = dest + ".replaced"
            if os.path.isdir(dest):   # overwrite (rollback replay)
                # Two-phase replace: the committed dir moves aside under a
                # name the torn-tmp sweep RESTORES (not deletes) before the
                # new one lands, so no crash point leaves the step without
                # an intact copy.
                if os.path.isdir(replaced):
                    shutil.rmtree(replaced)
                os.rename(dest, replaced)
            os.rename(tmp, dest)
            _fsync_dir(self._dir)
            if os.path.isdir(replaced):
                shutil.rmtree(replaced)
            self._stamp_stream_format()
        rt.barrier(f"ckpt_committed_{step}")
        self._stamp_pending = False
        self._gc()

    @staticmethod
    def _merge_fragments(tmp: str, entries: dict) -> dict:
        """Fold the other processes' manifest fragments into process 0's
        entries (each fragment's shard entries after process 0's, the
        fragments in name order)."""
        for name in sorted(os.listdir(tmp)):
            if not name.startswith("manifest.p") or not name.endswith(".json"):
                continue
            with open(os.path.join(tmp, name)) as f:
                frag = json.load(f)
            for key, entry in frag.items():
                if key in entries:
                    entries[key]["shards"].extend(entry["shards"])
                else:
                    entries[key] = entry
        return entries

    def _gc(self) -> None:
        keep = self.cfg.max_to_keep
        if keep is None or self._process != 0:
            return
        for s in self._committed_steps()[:-keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            log.info("checkpoint step %d garbage-collected (max_to_keep=%d)", s, keep)

    # -- restore -------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = self._committed_steps()
        return steps[-1] if steps else None

    def restore_latest(self, abstract_state: Any) -> Optional[tuple[Any, int]]:
        """Restore the newest INTACT checkpoint, quarantining corrupt ones
        with a typed reason.

        ``abstract_state`` is the target tree; its leaves need only
        ``shape`` and ``dtype`` (tensors on the ``meta`` device will do).
        Returns (state, step), the state a tree like the target of CPU
        tensors, or None if no intact checkpoint exists. The report lands
        on the manager: ``last_restore_step``, ``last_restore_extra`` and
        ``quarantined`` ([(step, reason), ...] for every checkpoint the
        fallback walked past).
        """
        self.wait()
        expected = dict(_flatten_with_keys(abstract_state))
        self.quarantined = []
        self.last_restore_extra = {}
        self.last_restore_step = None
        excluded: set[int] = set()
        while True:
            steps = [s for s in rt.agree_on_steps(self._committed_steps())
                     if s not in excluded]
            if not steps:
                if self.quarantined:
                    log.error(
                        "no intact checkpoint left in %s (quarantined: %s)",
                        self._dir, self.quarantined,
                    )
                return None
            step = steps[-1]
            err: Optional[CorruptCheckpoint] = None
            manifest = None
            try:
                manifest = self._validate(step, expected)
            except CorruptCheckpoint as e:
                err = e
            if not rt.agree_all(err is None, f"ckpt_ok_{step}"):
                if err is None:
                    err = CorruptCheckpoint(step, "peer_corrupt",
                                            "another process's portion failed validation")
                self._quarantine(step, err)
                excluded.add(step)
                continue
            state = self._materialize(manifest, abstract_state)
            self._check_stream_format(manifest)
            self.last_restore_step = step
            self.last_restore_extra = dict(manifest.get("extra") or {})
            log.info("restored checkpoint from step %d", step)
            return state, step

    def _quarantine(self, step: int, err: CorruptCheckpoint) -> None:
        self.quarantined.append((step, err.reason))
        log.error(
            "checkpoint step %d failed validation (%s); quarantining and "
            "falling back to the next newest", step, err,
        )
        src = self._step_dir(step)
        if err.reason in ("peer_corrupt", "leaf_mismatch") or not os.path.isdir(src):
            # Locally intact (peer_corrupt), a schema/config mismatch
            # (moving good bytes aside on a config typo would destroy
            # them), or already gone: exclude, don't move.
            return
        base = os.path.join(self._dir, _QUARANTINE, f"step_{step:08d}-{err.reason}")
        dest, n = base, 1
        while os.path.exists(dest):
            n += 1
            dest = f"{base}-{n}"
        try:
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            os.rename(src, dest)
            with open(os.path.join(dest, "reason.json"), "w") as f:
                json.dump({"step": step, "reason": err.reason, "detail": err.detail}, f)
        except OSError as e:
            log.warning("could not quarantine %s: %s", src, e)
            shutil.rmtree(src, ignore_errors=True)

    def _owns_crc(self, fname: str) -> bool:
        """The checksum pass divided across the processes: a file's owner is
        its name's CRC modulo the current process count (not the writer's
        index, so a checkpoint written by more processes than read it is
        still read whole). Sizes and extents are checked everywhere; the
        verdicts meet in ``agree_all``."""
        if self._count == 1:
            return True
        return zlib.crc32(fname.encode()) % self._count == self._process

    def _validate(self, step: int, expected: Optional[dict] = None) -> dict:
        """Full integrity pass over one committed checkpoint; raises
        CorruptCheckpoint with a typed reason on the first failure.
        ``checkpoint.verify_restore=false`` skips only the CRC pass."""
        sdir = self._step_dir(step)
        mpath = os.path.join(sdir, _MANIFEST)
        if not os.path.exists(mpath):
            raise CorruptCheckpoint(step, "missing_manifest", sdir)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CorruptCheckpoint(step, "bad_manifest", str(e))
        if not isinstance(manifest, dict) \
                or manifest.get("format") != CKPT_FORMAT \
                or not isinstance(manifest.get("leaves"), dict):
            raise CorruptCheckpoint(
                step, "bad_manifest",
                f"unsupported format {manifest.get('format')!r}"
                if isinstance(manifest, dict) else "not a dict",
            )
        leaves = manifest["leaves"]
        if expected is not None:
            missing = sorted(set(expected) - set(leaves))
            surplus = sorted(set(leaves) - set(expected))
            if missing or surplus:
                raise CorruptCheckpoint(
                    step, "leaf_mismatch",
                    f"missing={missing[:3]} surplus={surplus[:3]}",
                )
        for key, entry in leaves.items():
            shape = tuple(entry["shape"])
            itemsize = _storage_dtype(entry["dtype"]).itemsize
            if expected is not None:
                target = expected[key]
                if tuple(target.shape) != shape \
                        or _dtype_name(target.dtype) != entry["dtype"]:
                    raise CorruptCheckpoint(
                        step, "leaf_mismatch",
                        f"{key}: saved {entry['dtype']}{list(shape)} vs "
                        f"target {_dtype_name(target.dtype)}{list(target.shape)}",
                    )
            covered = 0
            for shard in entry["shards"]:
                path = os.path.join(sdir, shard["file"])
                if not os.path.exists(path):
                    raise CorruptCheckpoint(step, "missing_array", f"{key}: {shard['file']}")
                size = os.path.getsize(path)
                if size != shard["nbytes"]:
                    raise CorruptCheckpoint(
                        step, "truncated_array",
                        f"{key}: {shard['file']} is {size} bytes, manifest "
                        f"says {shard['nbytes']}",
                    )
                ext = _extent(_norm_index(shard["index"], shape))
                want = int(np.prod(ext, dtype=np.int64)) * itemsize
                if size != want:
                    raise CorruptCheckpoint(
                        step, "truncated_array",
                        f"{key}: {shard['file']} holds {size} bytes for a "
                        f"{entry['dtype']}{list(ext)} region ({want} expected)",
                    )
                if self.cfg.verify_restore and self._owns_crc(shard["file"]):
                    crc = 0
                    with open(path, "rb") as f:
                        for chunk in iter(lambda: f.read(1 << 22), b""):
                            crc = zlib.crc32(chunk, crc)
                    if crc != shard["crc32"]:
                        raise CorruptCheckpoint(
                            step, "bad_checksum",
                            f"{key}: {shard['file']} crc {crc} != manifest "
                            f"{shard['crc32']}",
                        )
                covered += int(np.prod(ext, dtype=np.int64))
            if covered != int(np.prod(shape, dtype=np.int64)):
                raise CorruptCheckpoint(
                    step, "missing_array",
                    f"{key}: shards cover {covered} of "
                    f"{int(np.prod(shape, dtype=np.int64))} elements",
                )
        manifest["_dir"] = sdir
        return manifest

    def _materialize(self, manifest: dict, abstract_state: Any) -> Any:
        """The validated checkpoint as a tree like ``abstract_state`` of CPU
        tensors, each leaf assembled from its shard files into memory the
        torch allocator owns (its alignment, not numpy's: CPU kernels pick
        their vector loops by the address, and a resumed run must take
        the uninterrupted run's). With ``CheckpointShards`` each sharded
        leaf is this process's block of it, read from the shards that
        overlap it."""
        sdir = manifest["_dir"]
        by_key = {}
        for key, _ in _flatten_with_keys(abstract_state):
            entry = manifest["leaves"][key]
            shape = tuple(entry["shape"])
            dtype = _storage_dtype(entry["dtype"])
            maps = []
            for shard in entry["shards"]:
                index = _norm_index(shard["index"], shape)
                mm = np.memmap(os.path.join(sdir, shard["file"]), dtype=dtype,
                               mode="r", shape=_extent(index))
                maps.append((index, mm))
            want = None
            if key in self._spec_of and is_sharded(self._spec_of[key][1]):
                want = block_index(shape, self._spec_of[key][1], self._shards.sizes,
                                   self._shards.coords)
            want = _norm_index(want, shape)
            out = torch.from_numpy(np.empty(0, dtype)).new_empty(_extent(want))
            self._fill(out.numpy(), want, maps)
            by_key[key] = out.view(torch.bfloat16) if entry["dtype"] == "bfloat16" else out
            del maps
        return _rebuild(abstract_state, by_key)

    @staticmethod
    def _fill(out: np.ndarray, want: list, maps) -> None:
        """Read the region ``want`` of a leaf into ``out`` from the saved
        shard files (one file for a leaf saved whole): each shard's overlap
        with the region."""
        for have, mm in maps:
            dst, src = [], []
            for (ws, we), (hs, he) in zip(want, have):
                lo, hi = max(ws, hs), min(we, he)
                if lo >= hi:
                    break
                dst.append(slice(lo - ws, hi - ws))
                src.append(slice(lo - hs, hi - hs))
            else:
                out[tuple(dst)] = mm[tuple(src)]

    # -- lifecycle -----------------------------------------------------------

    def wait(self) -> None:
        """Block until async saves land (call before process exit); raises
        the first async save error, if any."""
        if self._worker is not None and self._worker.is_alive():
            self._queue.join()
        if self.save_error is not None:
            err, self.save_error = self.save_error, None
            raise RuntimeError("async checkpoint save failed") from err
        if self._stamp_pending:  # sync-path leftovers only
            self._stamp_pending = False
            self._stamp_stream_format()

    def close(self) -> None:
        self.wait()
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(None)
            self._worker.join(timeout=10)
        self._worker = None
