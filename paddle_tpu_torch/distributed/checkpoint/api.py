"""Checkpoint save / load in the JAX package's format
(``paddle_tpu/distributed/checkpoint/api.py`` counterpart:
`save_state_dict` :173, `wait_async_save` :208, `_load_metadata` :257,
`load_state_dict` :358, `verify_checkpoint` :447, `CheckpointManager`
:527-740).

The files are the JAX package's: each process writes its tensors' bytes
at recorded offsets in one ``<pid>.distcp`` file, with a CRC32 per
shard, then the metadata (global shape, per-shard offsets and byte
ranges, dtype names) as ``<pid>.metadata``; every file lands as a
``*.tmp`` that is fsync'd and renamed, the metadata last.  A checkpoint
either package writes, the other loads, with the same keys and bytes.

What differs from the JAX module:
  * the metadata pickle names the JAX package's module for its classes
    (`_pickle`): the JAX loader resolves them, and the port maps the
    name back to its copy (`metadata`) without importing the JAX
    package;
  * a dtype numpy has no name for (bfloat16; the JAX package reads it
    through ``ml_dtypes``) travels as its raw words (`_np_dtype`): the
    host copy of a bf16 tensor is its 2-byte words as uint16, written
    under the dtype string ``"bfloat16"``, and read back as uint16 and
    viewed as ``torch.bfloat16``;
  * one device, so no resharding: `load_state_dict` assembles each
    tensor's global value from the shards it was saved in (one, or the
    JAX package's several) and copies it into the target tensor in
    place, which keeps the addresses a CUDA graph holds.

The functions and the class this module shares with the JAX one are
copies of its code.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import _pickle as pickle
from .metadata import (
    CheckpointCorruptionError, LocalTensorIndex, LocalTensorMetadata,
    Metadata, shard_checksum,
)

# introspection for tests: peak block size (elements) assembled by the last
# load, and which keys fell back to full-tensor materialization
last_load_stats = {"max_block_elems": 0, "full_materialized": []}

# dtype names the JAX package writes that numpy lacks -> the unsigned
# words of the same width they travel as
_WORDS = {"bfloat16": np.uint16}


def _proc_id():
    """This process's rank under torch.distributed, else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _np_dtype(name):
    """The numpy dtype a stored dtype string is read as: itself, or for
    a dtype numpy lacks its raw words."""
    if name in _WORDS:
        return np.dtype(_WORDS[name])
    return np.dtype(name)


def _host(t):
    """A tensor's host copy as numpy (a copy even of a CPU tensor: the
    caller may update it while an async save writes), in its raw words
    where numpy has no dtype for it; and its dtype string."""
    name = str(t.dtype).split(".")[-1]
    v = t.detach().to("cpu", copy=True).contiguous()
    if name in _WORDS:
        return v.view(torch.int16).numpy().view(_WORDS[name]), name
    return v.numpy(), name


_async_save_thread = None
_async_save_error = None  # exception raised inside the async save thread


def _fire_fault(point, **ctx):
    """Resilience fault-point hook (None when the harness is idle)."""
    try:
        from ...resilience import faults as _faults
    except ImportError:
        return None
    return _faults.fire(point, **ctx)


def _fsync_and_rename(tmp_path, final_path):
    """Commit one file atomically: the tmp is already fsync'd; rename
    over the final name, then fsync the directory so the rename itself
    is durable."""
    os.rename(tmp_path, final_path)
    try:
        dfd = os.open(os.path.dirname(final_path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # directory fsync is best-effort (not all filesystems)


def _snapshot_host(state_dict):
    """Device→host snapshot: list of (key, global_shape, dtype_str,
    [(offset, np_array)]), one shard per tensor (one device)."""
    snap = []
    for key, t in state_dict.items():
        t = torch.as_tensor(t)
        arr, dtype_str = _host(t)
        snap.append((key, tuple(t.shape), dtype_str,
                     [((0,) * t.dim(), arr)]))
    return snap


def _write_snapshot(snap, path, pid, coordinator_rank):
    """Atomic, checksummed write of one process's shards + metadata.

    Torn-write hardening (docs/RESILIENCE.md): all bytes land in
    `*.tmp` files that are fsync'd then renamed into place; the
    metadata file is committed LAST, so a kill at any point leaves
    either the complete previous checkpoint or a loadable new one —
    never a half-written state a loader would trust.  Each stored
    byte-range records its CRC32 for verification on load.
    """
    action = _fire_fault("checkpoint.write", path=path, pid=pid)
    meta = Metadata()
    fname = f"{pid}.distcp"
    tmp_data = os.path.join(path, fname + ".tmp")
    total = sum(arr.nbytes for _k, _g, _d, shards in snap
                for _o, arr in shards)
    pos = 0
    with open(tmp_data, "wb") as f:
        for key, gshape, dtype_str, shards in snap:
            entries = []
            for offset, arr in shards:
                raw = arr.tobytes()
                if action is not None and action.kind == "torn" and \
                        pos + len(raw) > total // 2:
                    # simulated mid-write kill: half the bytes are down,
                    # no rename, no metadata — the previous checkpoint
                    # must remain the loadable one
                    f.write(raw[:max(1, len(raw) // 2)])
                    f.flush()
                    from ...resilience.faults import InjectedFault

                    raise InjectedFault("checkpoint.write", kind="torn",
                                        call=action.call, file=fname)
                f.write(raw)
                entries.append(LocalTensorMetadata(
                    offset, tuple(arr.shape), dtype_str))
                meta.storage_metadata[LocalTensorIndex(key, offset)] = {
                    "file": fname, "byte_offset": pos, "nbytes": len(raw),
                    "crc32": shard_checksum(raw),
                }
                pos += len(raw)
            meta.state_dict_metadata[key] = {
                "global_shape": gshape,
                "dtype": dtype_str,
                "shards": entries,
            }
        f.flush()
        os.fsync(f.fileno())
    _fsync_and_rename(tmp_data, os.path.join(path, fname))
    if action is not None and action.kind == "corrupt":
        # simulated bit-rot AFTER a clean commit: the CRCs recorded in
        # the metadata no longer match the bytes on disk
        from ...resilience.faults import corrupt_file

        corrupt_file(os.path.join(path, fname),
                     seed=action.payload.get("seed", 0))
    if pid == coordinator_rank:
        tmp_meta = os.path.join(path, f"{pid}.metadata.tmp")
        with open(tmp_meta, "wb") as f:
            pickle.dump(meta, f, protocol=4)
            f.flush()
            os.fsync(f.fileno())
        _fsync_and_rename(tmp_meta, os.path.join(path, f"{pid}.metadata"))


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None, async_save=False):
    """Write each process's addressable shards + metadata.

    `async_save=True` (reference async-save semantics, SURVEY §5
    checkpoint row): the device→host copy happens synchronously — the
    snapshot is consistent even if training immediately mutates/donates
    the state — then file IO runs on a background thread. Overlapping
    saves are serialized; `wait_async_save()` is the completion barrier
    (also called automatically by the next save/load).
    """
    os.makedirs(path, exist_ok=True)
    pid = _proc_id()
    wait_async_save()  # serialize with (and surface errors from) any
    # in-flight save
    snap = _snapshot_host(state_dict)
    if async_save:
        global _async_save_thread
        import threading

        def _run():
            global _async_save_error
            try:
                _write_snapshot(snap, path, pid, coordinator_rank)
            except BaseException as e:  # captured, re-raised on wait
                _async_save_error = e

        _async_save_thread = threading.Thread(
            target=_run, daemon=False, name="distcp-async-save")
        _async_save_thread.start()
        _register_atexit_join()
        return
    _write_snapshot(snap, path, pid, coordinator_rank)


def wait_async_save():
    """Block until the last `save_state_dict(..., async_save=True)` has
    fully hit disk (completion barrier; no-op when nothing is in flight).

    An exception raised inside the save thread is captured there and
    RE-RAISED here — the first save/load/wait after the failure sees it
    (a silently-lost async checkpoint is a checkpoint you discover is
    missing only when restoring from a crash)."""
    global _async_save_thread, _async_save_error
    t = _async_save_thread
    if t is not None:
        t.join()
        _async_save_thread = None
    err = _async_save_error
    if err is not None:
        _async_save_error = None
        raise err


_atexit_registered = False


def _register_atexit_join():
    """Join a still-running async save at interpreter exit (a clean
    process teardown must not truncate a checkpoint mid-write); a
    captured failure is reported, not raised (atexit can't propagate)."""
    global _atexit_registered
    if _atexit_registered:
        return
    _atexit_registered = True
    import atexit

    def _drain():
        global _async_save_thread, _async_save_error
        t = _async_save_thread
        if t is not None:
            t.join()
            _async_save_thread = None
        if _async_save_error is not None:
            import sys

            print(f"[checkpoint] async save failed: "
                  f"{type(_async_save_error).__name__}: "
                  f"{_async_save_error}", file=sys.stderr)
            _async_save_error = None

    atexit.register(_drain)


def _load_metadata(path):
    metas = []
    for name in sorted(os.listdir(path)):
        if name.endswith(".metadata"):
            with open(os.path.join(path, name), "rb") as f:
                metas.append(pickle.load(f))
    if not metas:
        return None
    # multi-host: coordinator wrote one file; merge defensively if several
    meta = metas[0]
    for extra in metas[1:]:
        meta.state_dict_metadata.update(extra.state_dict_metadata)
        meta.storage_metadata.update(extra.storage_metadata)
    return meta


class _ShardReader:
    """Reads saved shard byte-ranges on demand; caches open file handles,
    never whole files."""

    def __init__(self, path, meta):
        self.path = path
        self.meta = meta
        self._files = {}

    def read(self, key, entry):
        loc = self.meta.storage_metadata.get(
            LocalTensorIndex(key, tuple(entry.global_offset)))
        if loc is None:
            return None
        if isinstance(loc, str):  # legacy layout: whole-file pickle
            cached = self._files.get(("pickle", loc))
            if cached is None:
                with open(os.path.join(self.path, loc), "rb") as f:
                    cached = pickle.load(f)
                self._files[("pickle", loc)] = cached
            return cached[
                f"{key}@{'_'.join(map(str, entry.global_offset))}"]
        f = self._files.get(loc["file"])
        if f is None:
            f = open(os.path.join(self.path, loc["file"]), "rb")
            self._files[loc["file"]] = f
        f.seek(loc["byte_offset"])
        raw = f.read(loc["nbytes"])
        if len(raw) != loc["nbytes"]:
            raise CheckpointCorruptionError(
                f"checkpoint shard {key!r}@{entry.global_offset} in "
                f"{loc['file']} truncated: wanted {loc['nbytes']} bytes, "
                f"got {len(raw)}", key=key, file=loc["file"])
        want = loc.get("crc32")
        if want is not None and shard_checksum(raw) != want:
            raise CheckpointCorruptionError(
                f"checkpoint shard {key!r}@{entry.global_offset} in "
                f"{loc['file']} failed CRC32 verification (stored "
                f"{want:#010x}, computed {shard_checksum(raw):#010x})",
                key=key, file=loc["file"])
        dt = _np_dtype(entry.dtype)
        return np.frombuffer(raw, dtype=dt).reshape(entry.local_shape)

    def close(self):
        for f in self._files.values():
            if hasattr(f, "close"):
                f.close()
        self._files.clear()


def _assemble_block(key, info, reader, block_index):
    """Assemble one target block (tuple of slices into the global tensor)
    from the saved shards that intersect it."""
    gshape = info["global_shape"]
    dt = _np_dtype(info["dtype"])
    starts = [s.start or 0 for s in block_index]
    stops = [s.stop if s.stop is not None else dim
             for s, dim in zip(block_index, gshape)]
    bshape = tuple(b - a for a, b in zip(starts, stops))
    if not bshape:  # scalar
        entry = info["shards"][0]
        return reader.read(key, entry).reshape(())
    # zeros, not empty: a region no readable shard covers (missing file,
    # stale metadata) must not surface uninitialized memory as weights
    block = np.zeros(bshape, dtype=dt)
    last_load_stats["max_block_elems"] = max(
        last_load_stats["max_block_elems"], int(np.prod(bshape) or 1))
    for entry in info["shards"]:
        e_lo = list(entry.global_offset)
        e_hi = [o + s for o, s in zip(entry.global_offset, entry.local_shape)]
        lo = [max(a, b) for a, b in zip(starts, e_lo)]
        hi = [min(a, b) for a, b in zip(stops, e_hi)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        src = reader.read(key, entry)
        if src is None:
            continue
        src_sl = tuple(slice(a - o, b - o)
                       for a, b, o in zip(lo, hi, e_lo))
        dst_sl = tuple(slice(a - s, b - s)
                       for a, b, s in zip(lo, hi, starts))
        block[dst_sl] = src[src_sl]
    return block


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None,
                    offload=False):
    """Fill `state_dict`'s tensors in place from the checkpoint: each
    key the checkpoint holds is assembled from its saved shards and
    copied into the target tensor (on its device, in its dtype), whose
    shape must be the saved global shape.  Keys the checkpoint lacks
    and values that are not tensors are left as they are."""
    wait_async_save()  # an async save of `path` just begun must land first
    meta = _load_metadata(path)
    if meta is None:
        raise ValueError(f"no checkpoint metadata found under {path!r}")
    last_load_stats["max_block_elems"] = 0
    last_load_stats["full_materialized"] = []
    reader = _ShardReader(path, meta)
    try:
        for key, t in state_dict.items():
            if key not in meta.state_dict_metadata or \
                    not isinstance(t, torch.Tensor):
                continue
            info = meta.state_dict_metadata[key]
            gshape = tuple(info["global_shape"])
            if gshape != tuple(t.shape):
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape {gshape}, the "
                    f"target {tuple(t.shape)}")
            full = _assemble_block(
                key, info, reader, tuple(slice(0, d) for d in gshape))
            last_load_stats["full_materialized"].append(key)
            val = torch.from_numpy(np.array(full)).view(
                getattr(torch, info["dtype"]))
            with torch.no_grad():
                t.copy_(val.reshape(gshape))
    finally:
        reader.close()
    return state_dict


def verify_checkpoint(path, deep=True):
    """Integrity-check the checkpoint at `path`.

    deep=True (tools/tests): read every stored byte range and check it
    against its recorded CRC32 — full bit-rot detection without
    materializing tensors.  deep=False (the restore hot path): only
    structural checks — metadata present, shard files exist, every
    recorded byte range fits the file — leaving CRC verification to the
    shard reader, which checksums each range as it streams it anyway
    (so a restore pays ONE read+CRC pass, not two).

    Returns {"files", "shards", "bytes", "unverified"} on success
    (`unverified` counts v1 entries with no CRC); raises
    `CheckpointCorruptionError` on any failure.
    """
    meta = _load_metadata(path)
    if meta is None:
        raise CheckpointCorruptionError(
            f"no checkpoint metadata found under {path!r}")
    files, shards, nbytes, unverified = set(), 0, 0, 0
    handles = {}
    sizes = {}
    try:
        for idx, loc in meta.storage_metadata.items():
            if isinstance(loc, str):  # legacy whole-file pickle layout
                unverified += 1
                continue
            fpath = os.path.join(path, loc["file"])
            if deep:
                f = handles.get(fpath)
                if f is None:
                    try:
                        f = handles[fpath] = open(fpath, "rb")
                    except OSError as e:
                        raise CheckpointCorruptionError(
                            f"checkpoint shard file {loc['file']!r} missing "
                            f"under {path!r}: {e}", key=idx.tensor_key,
                            file=loc["file"]) from e
                f.seek(loc["byte_offset"])
                raw = f.read(loc["nbytes"])
                if len(raw) != loc["nbytes"]:
                    raise CheckpointCorruptionError(
                        f"shard {idx.tensor_key!r}@{idx.global_offset} "
                        f"truncated in {loc['file']}", key=idx.tensor_key,
                        file=loc["file"])
                want = loc.get("crc32")
                if want is None:
                    unverified += 1
                elif shard_checksum(raw) != want:
                    raise CheckpointCorruptionError(
                        f"shard {idx.tensor_key!r}@{idx.global_offset} "
                        f"failed CRC32 in {loc['file']}",
                        key=idx.tensor_key, file=loc["file"])
            else:
                size = sizes.get(fpath)
                if size is None:
                    try:
                        size = sizes[fpath] = os.path.getsize(fpath)
                    except OSError as e:
                        raise CheckpointCorruptionError(
                            f"checkpoint shard file {loc['file']!r} missing "
                            f"under {path!r}: {e}", key=idx.tensor_key,
                            file=loc["file"]) from e
                if loc["byte_offset"] + loc["nbytes"] > size:
                    raise CheckpointCorruptionError(
                        f"shard {idx.tensor_key!r}@{idx.global_offset} "
                        f"extends past {loc['file']} ({size} bytes)",
                        key=idx.tensor_key, file=loc["file"])
                if loc.get("crc32") is None:
                    unverified += 1
            files.add(loc["file"])
            shards += 1
            nbytes += loc["nbytes"]
    finally:
        for f in handles.values():
            f.close()
    return {"files": len(files), "shards": shards, "bytes": nbytes,
            "unverified": unverified}


class CheckpointManager:
    """Keep-last-K checkpoint rotation with a `latest` pointer and
    verify-then-rollback restore — the recovery target the guard
    escalation and the elastic restart path load through.

    Layout under `root`:
        ckpt_00000007/          one save_state_dict checkpoint each
        ckpt_00000008/
        latest                  text file: basename of the newest commit
    Saves are atomic end-to-end (shard files and metadata commit via
    tmp+fsync+rename inside save_state_dict; the pointer file commits
    the same way).  With `async_save=True` the pointer is written
    optimistically before the background write lands — safe because
    `latest_step()`/`restore()` only ever trust COMMITTED checkpoints
    (metadata present, CRCs verified) and fall back otherwise.
    Pruning keeps the newest `keep_last_k` directories,
    and `restore()` walks newest → oldest, quarantining any checkpoint
    that fails CRC verification (renamed to `<dir>.corrupt`) until one
    verifies — a torn/corrupted latest falls back to the previous one
    instead of killing the run.
    """

    LATEST = "latest"

    def __init__(self, root, keep_last_k=3):
        self.root = str(root)
        self.keep_last_k = max(1, int(keep_last_k))
        self._inflight_step = None  # step a possibly-async save targets
        os.makedirs(self.root, exist_ok=True)

    # --- naming -------------------------------------------------------------
    def _dir(self, step):
        return os.path.join(self.root, f"ckpt_{int(step):08d}")

    def _step_of(self, name):
        try:
            return int(name.split("_", 1)[1])
        except (IndexError, ValueError):
            return None

    def checkpoints(self):
        """Committed checkpoint steps, oldest → newest (a checkpoint is
        committed iff its metadata file exists)."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            step = None
            if name.startswith("ckpt_") and not name.endswith(".corrupt"):
                step = self._step_of(name)
            if step is None:
                continue
            d = os.path.join(self.root, name)
            if any(n.endswith(".metadata") for n in
                   (os.listdir(d) if os.path.isdir(d) else ())):
                out.append(step)
        return sorted(out)

    def _committed(self, step):
        d = self._dir(step)
        return os.path.isdir(d) and any(
            n.endswith(".metadata") for n in os.listdir(d))

    def latest_step(self):
        """The step the `latest` pointer names — but only if that
        checkpoint is COMMITTED (metadata present).  The pointer is
        written optimistically before an async save lands, so a pointer
        to a not-yet/never-committed dir (crash mid-async-write) falls
        back to the newest committed checkpoint instead of handing a
        torn directory to an elastic restart."""
        p = os.path.join(self.root, self.LATEST)
        try:
            with open(p) as f:
                step = self._step_of(f.read().strip())
            if step is not None and self._committed(step):
                return step
        except OSError:
            pass
        steps = self.checkpoints()
        return steps[-1] if steps else None

    def latest_path(self):
        step = self.latest_step()
        return None if step is None else self._dir(step)

    # --- save ---------------------------------------------------------------
    def save(self, state_dict, step=None, async_save=False):
        """Write checkpoint `step` (default: newest+1), move the
        `latest` pointer, prune beyond keep_last_k.  Returns the
        checkpoint directory path."""
        if step is None:
            # join any in-flight async save FIRST: its metadata commit
            # is what makes its step visible to checkpoints(), and
            # without it back-to-back async saves would both pick the
            # same step and overwrite each other
            wait_async_save()
            steps = self.checkpoints()
            step = (steps[-1] + 1) if steps else 0
        path = self._dir(step)
        self._inflight_step = int(step)  # prune must never touch it
        save_state_dict(state_dict, path, async_save=async_save)
        self._commit_pointer(path)
        self.prune()
        return path

    def _commit_pointer(self, path):
        tmp = os.path.join(self.root, self.LATEST + ".tmp")
        with open(tmp, "w") as f:
            f.write(os.path.basename(path) + "\n")
            f.flush()
            os.fsync(f.fileno())
        _fsync_and_rename(tmp, os.path.join(self.root, self.LATEST))

    def prune(self):
        """Drop committed checkpoints beyond the newest keep_last_k
        (never the one `latest` points at), plus dead torn-save litter:
        uncommitted ckpt dirs OLDER than the newest commit can never be
        finished (only the newest save may still be landing async), so
        they are removed instead of leaking one per mid-write kill.
        Quarantined `.corrupt` dirs are kept — they are evidence."""
        import shutil

        steps = self.checkpoints()
        keep = set(steps[-self.keep_last_k:])
        latest = self.latest_step()
        if latest is not None:
            keep.add(latest)
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._dir(s), ignore_errors=True)
        newest = steps[-1] if steps else None
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            if not name.startswith("ckpt_") or name.endswith(".corrupt"):
                continue
            s = self._step_of(name)
            if s is None or s in steps or s == self._inflight_step:
                # _inflight_step may still be landing on the async
                # writer thread (an explicit step below the newest
                # commit is legal) — never rmtree under it
                continue
            if newest is not None and s < newest:
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    # --- restore ------------------------------------------------------------
    def restore(self, state_dict):
        """Fill `state_dict` from the newest checkpoint that passes CRC
        verification (checked shard-by-shard as the load streams),
        quarantining failed ones and rolling back to the previous —
        raises CheckpointCorruptionError only when NO checkpoint in the
        rotation survives.  Returns the step loaded.  A corrupt attempt
        may partially fill `state_dict` before the fallback load
        rewrites it; rotation checkpoints of one run share a key set,
        so the successful load overwrites every touched leaf."""
        try:
            wait_async_save()  # an in-flight save must land first...
        except Exception as e:
            # ...but a FAILED async save must not block recovery: the
            # whole point of restore() is falling back to the last
            # committed checkpoint.  The failure is recorded, consumed,
            # and the rotation walk below decides what is loadable.
            try:
                from ...observability import flight as _flight

                _flight.record("resilience.async_save_error_at_restore",
                               error=f"{type(e).__name__}: {e}")
            except Exception:  # pt-lint: ok[PT005]
                pass           # (observability fan-out guard)
        steps = self.checkpoints()
        latest = self.latest_step()
        if latest in steps:  # pointer order wins, then newest-first
            steps = [s for s in steps if s != latest] + [latest]
        if not steps:
            raise CheckpointCorruptionError(
                f"no committed checkpoints under {self.root!r}")
        last_err = None
        for step in reversed(steps):
            path = self._dir(step)
            try:
                # structural gate only — the shard reader CRC-verifies
                # every byte range as the load streams it, so recovery
                # pays one read pass, not verify+load double I/O
                verify_checkpoint(path, deep=False)
                load_state_dict(state_dict, path)
                return step
            except CheckpointCorruptionError as e:
                last_err = e
                self._quarantine(path, e)
        raise CheckpointCorruptionError(
            f"every checkpoint under {self.root!r} failed verification "
            f"(last: {last_err})") from last_err

    def _quarantine(self, path, err):
        """Move a corrupt checkpoint aside (evidence, and so the next
        restore doesn't re-verify it) and record the rollback."""
        try:
            os.rename(path, path + ".corrupt")
        except OSError:
            pass
        try:
            from ...observability import flight as _flight
            from ...observability import metrics as _metrics

            _metrics.inc("resilience.rollbacks")
            _flight.record("resilience.checkpoint_rollback", path=path,
                           error=f"{type(err).__name__}: {err}")
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard)
