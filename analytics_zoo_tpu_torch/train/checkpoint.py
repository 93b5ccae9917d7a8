"""Checkpoint / resume, in the JAX package's archive format.

One ``.npz`` holds every array leaf keyed ``{i:06d}|{key/path}`` (the
leaf's index in the flattened tree, then its key path: dict keys sorted,
sequence items by position), a ``__manifest__`` (JSON: format version and
each leaf's CRC32, dtype and shape) and a ``__treedef__``.  The JAX
package pickles its tree structure there; unpickling that would import
jax, so the port never does: it rebuilds nested dicts from the leaf keys,
and writes its own ``__treedef__`` as JSON naming the sequence nodes
(``{"format": ..., "sequences": [path, ...]}``), which its reader turns
back into lists.  A port archive carries the JAX key layout and CRCs, so
its manifest checks pass in either package, and a parameter archive
written by the JAX package (``save_model``'s ``weights.npz``,
``save_weights``) loads here by key path.  No pickle of a torch object is
written: tensors are stored as numpy arrays.

Durability, as in the JAX package:

- **atomic + synced writes** — a tempfile in the target directory,
  ``fsync``, ``os.replace`` onto the final path, then ``fsync`` of the
  directory: a preemption at any instant leaves the old file set or the
  new one, never a torn archive at the final path.
- **per-leaf CRC32 manifest** — ``load_pytree(verify=True)`` recomputes
  every leaf's CRC and raises :class:`CheckpointCorruptError` on a
  mismatch.
- **verified fallback restore** — ``CheckpointManager.restore()`` walks
  snapshots newest to oldest, quarantines torn or corrupt ones (renamed
  ``*.corrupt``, counted in ``robust/ckpt_quarantined``) and recovers
  from the newest intact one.
- **retried writes** — transient ``OSError``s go through a
  ``RetryPolicy``.

``save_async`` (the ``async_checkpoint`` knob) copies the snapshot off
the live tensors before it returns — the Estimator updates parameters in
place, so a reference would see later steps.  On the card the copies go
into pinned host buffers that the manager keeps for the next snapshot
(as many bytes as the snapshot's tensors), queued on the current stream
after the steps already issued, so later in-place updates come after
them and nothing waits; on the CPU the tensors are cloned.  The CRCs, the
write and the fsync then run on a thread, from buffers that the writer
neither copies nor holds the GIL over (``_bytes``), so training runs on
beside it.  ``wait()`` joins it and re-raises its error; restore waits
first, so a reader never races the writer, and GC runs under the
manager's lock.
"""

from __future__ import annotations

import json
import logging
import os
import re
import tempfile
import threading
import time
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.observe import metrics as obs
from analytics_zoo_tpu_torch.robust import RetryPolicy, faults

logger = logging.getLogger("analytics_zoo_tpu_torch.train")

_MANIFEST = "__manifest__"
_TREEDEF = "__treedef__"
FORMAT_VERSION = 2
_PORT_FORMAT = "analytics_zoo_tpu_torch"


class CheckpointCorruptError(RuntimeError):
    """The archive is readable but fails integrity verification
    (missing manifest entries or a per-leaf CRC32 mismatch)."""


def _bytes(a: np.ndarray):
    """The array's bytes in C order as a buffer, without a copy where it
    is contiguous: a copy would hold the GIL for its whole length, while
    ``zlib.crc32`` and a file's ``write`` release it for a large buffer,
    so a training thread runs on while a writer thread streams a
    snapshot."""
    a = np.asarray(a, order="C")
    return memoryview(a).cast("B") if a.size else b""


def _crc32(a: np.ndarray) -> int:
    return zlib.crc32(_bytes(a)) & 0xFFFFFFFF


def _write_npz(f, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez``'s archive: a stored zip of ``{key}.npy`` members, each
    an ``.npy`` header and the array's bytes, written from the array's
    own buffer (``_bytes``)."""
    with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in arrays.items():
            a = np.asarray(a, order="C")
            with zf.open(key + ".npy", "w", force_zip64=True) as out:
                np.lib.format.write_array_header_1_0(
                    out, np.lib.format.header_data_from_array_1_0(a))
                out.write(_bytes(a))


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, path=(), out=None, seqs=None):
    """``[(key path, leaf)]`` in the JAX package's flattening order (dict
    keys sorted, sequences by position, None and empty nodes without
    leaves), and the paths of the sequence nodes."""
    if out is None:
        out, seqs = [], []
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], path + (str(k),), out, seqs)
    elif isinstance(tree, (list, tuple)):
        seqs.append("/".join(path))
        for i, v in enumerate(tree):
            _flatten(v, path + (str(i),), out, seqs)
    elif tree is not None:
        out.append(("/".join(path), tree))
    return out, seqs


def _unflatten(paths_leaves, seqs) -> Any:
    """Nested dicts from ``(key path, leaf)``; the nodes at ``seqs`` become
    lists ordered by index."""
    root: Dict[str, Any] = {}
    for path, leaf in paths_leaves:
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def fix(node, path):
        if not isinstance(node, dict):
            return node
        out = {k: fix(v, f"{path}/{k}" if path else k)
               for k, v in node.items()}
        if path in seqs:
            return [out[k] for k in sorted(out, key=int)]
        return out

    return fix(root, "")


def _fsync_dir(dirname: str) -> None:
    """Persist the rename itself (POSIX: a rename is durable only once
    the containing directory is synced)."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_npz(path: str, arrays: Dict[str, np.ndarray],
                fsync: bool = True,
                fault_site: str = "checkpoint.write") -> None:
    """Write an ``.npz`` archive atomically and durably: tmp file, fsync,
    ``os.replace``, directory fsync.  ``fault_site`` is consulted between
    the flush and the rename: a planned exception is a death mid-write
    (final path untouched); ``action="torn"`` truncates the file first,
    as a non-atomic writer dying would leave it."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            _write_npz(f, arrays)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        plan = faults.fire(fault_site)
        if plan is not None:
            if plan.exc is not None:
                raise plan.exc
            if plan.action == "torn":
                frac = plan.payload if plan.payload is not None else 0.5
                size = os.path.getsize(tmp)
                with open(tmp, "r+b") as f:
                    f.truncate(max(1, int(size * float(frac))))
        os.replace(tmp, path)
        if fsync:
            _fsync_dir(dirname)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _atomic_text(path: str, text: str, fsync: bool = True) -> None:
    """A small text file with the archives' tmp, fsync, rename
    discipline."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            _fsync_dir(dirname)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_pytree(path: str, tree: Any, fsync: bool = True) -> None:
    """Atomically and durably save a tree (nested dicts, lists, tuples) of
    tensors, arrays and scalars to ``path``, with a CRC32 per leaf."""
    leaves, seqs = _flatten(tree)
    arrays: Dict[str, np.ndarray] = {}
    manifest_leaves: Dict[str, Dict[str, Any]] = {}
    for i, (p, leaf) in enumerate(leaves):
        key = f"{i:06d}|{p}"
        a = _host(leaf)
        arrays[key] = a
        manifest_leaves[key] = {"crc32": _crc32(a), "dtype": str(a.dtype),
                                "shape": list(a.shape)}
    treedef = np.frombuffer(json.dumps(
        {"format": _PORT_FORMAT, "sequences": seqs},
        sort_keys=True).encode("utf-8"), np.uint8)
    manifest_leaves[_TREEDEF] = {"crc32": _crc32(treedef), "dtype": "uint8",
                                 "shape": [int(treedef.size)]}
    manifest = {"version": FORMAT_VERSION, "leaves": manifest_leaves}
    manifest_bytes = np.frombuffer(
        json.dumps(manifest, sort_keys=True).encode("utf-8"), np.uint8)
    _atomic_npz(path, {_TREEDEF: treedef, _MANIFEST: manifest_bytes,
                       **arrays}, fsync=fsync)


def _sequences(treedef: Optional[np.ndarray]) -> List[str]:
    """The sequence nodes a port ``__treedef__`` names; none for the JAX
    package's pickled one, which is never unpickled."""
    if treedef is None:
        return []
    try:
        spec = json.loads(treedef.tobytes().decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        return []
    if isinstance(spec, dict) and spec.get("format") == _PORT_FORMAT:
        return list(spec.get("sequences", []))
    return []


def load_pytree(path: str, verify: bool = True) -> Any:
    """Load an archive written by either package; with ``verify``
    (default) recompute every leaf's CRC32 against the manifest.  An
    archive without a manifest (the JAX package's format v1) loads
    unverified.  Dicts come back as dicts, the sequences of a port
    archive as lists, leaves as numpy arrays."""
    with np.load(path, allow_pickle=False) as z:
        manifest = None
        if _MANIFEST in z.files:
            manifest = json.loads(z[_MANIFEST].tobytes().decode("utf-8"))
        elif verify:
            logger.debug("checkpoint %s has no integrity manifest "
                         "(pre-v%d format); loading unverified",
                         path, FORMAT_VERSION)
        treedef = z[_TREEDEF] if _TREEDEF in z.files else None
        keys = sorted((k for k in z.files if k not in (_TREEDEF, _MANIFEST)),
                      key=lambda k: int(k.split("|", 1)[0]))
        if verify and manifest is not None:
            expected = manifest.get("leaves", {})
            want = set(expected) - {_TREEDEF}
            have = set(keys)
            if want != have:
                raise CheckpointCorruptError(
                    f"{path}: manifest/leaf mismatch "
                    f"(missing={sorted(want - have)[:3]} "
                    f"extra={sorted(have - want)[:3]})")
            if _TREEDEF in expected and (
                    treedef is None
                    or _crc32(treedef) != expected[_TREEDEF]["crc32"]):
                raise CheckpointCorruptError(f"{path}: treedef CRC mismatch")
        leaves = []
        for k in keys:
            a = z[k]
            if verify and manifest is not None:
                if _crc32(a) != manifest["leaves"][k]["crc32"]:
                    raise CheckpointCorruptError(
                        f"{path}: CRC mismatch on leaf {k!r}")
            leaves.append((k.split("|", 1)[1], a))
    return _unflatten(leaves, set(_sequences(treedef)))


class CheckpointManager:
    """Numbered snapshots (``ckpt_{step:010d}.npz``) in a directory, with
    verified latest-recovery."""

    def __init__(self, directory: str, keep: int = 3, verify: bool = True,
                 retry: Optional[RetryPolicy] = None):
        self.directory = directory
        self.keep = keep
        self.verify = verify
        os.makedirs(directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._writer_err: Optional[BaseException] = None
        # serializes GC deletes against listings and restores, so a
        # background writer's GC never hands all_steps() or restore() a
        # half-deleted directory
        self._fs_lock = threading.Lock()
        self._retry = retry or RetryPolicy(
            max_attempts=3, base_delay_s=0.05, max_delay_s=1.0,
            retry_on=(OSError,), name="checkpoint_write")
        # pinned host buffers for save_async's copies of CUDA tensors, by
        # leaf path; free again once the write that reads them is joined
        self._pinned: Dict[str, torch.Tensor] = {}

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:010d}.npz")

    def save(self, step: int, tree: Any) -> str:
        self.wait()
        path = self._path(step)
        t0 = time.perf_counter()
        try:
            self._retry.call(save_pytree, path, tree)
        except BaseException:
            obs.count("checkpoint_total", op="save", status="error")
            raise
        obs.observe("checkpoint_seconds", time.perf_counter() - t0,
                    flat="checkpoint/write_sync", op="save")
        obs.count("checkpoint_total", op="save", status="ok")
        self._gc()
        return path

    def save_async(self, step: int, tree: Any) -> str:
        """Write the snapshot on a background thread (``async_checkpoint``).

        The tree is copied off the live tensors before this returns, so
        the caller may update them in place at once."""
        self.wait()
        cuda = []
        snapshot = self._copy_off(tree, "", cuda)
        copied = None
        if cuda:
            copied = torch.cuda.Event()
            copied.record()
        path = self._path(step)

        def write():
            t0 = time.perf_counter()
            try:
                if copied is not None:
                    copied.synchronize()
                self._retry.call(save_pytree, path, snapshot)
                obs.observe("checkpoint_seconds", time.perf_counter() - t0,
                            flat="checkpoint/write_async", op="save_async")
                obs.count("checkpoint_total", op="save_async", status="ok")
                self._gc()
            except BaseException as e:
                obs.count("checkpoint_total", op="save_async",
                          status="error")
                # wait() joins the thread before reading it
                self._writer_err = e

        self._writer = threading.Thread(target=write, daemon=True)
        self._writer.start()
        return path

    def _copy_off(self, tree, path, cuda):
        """A copy of ``tree`` that later in-place updates cannot reach:
        CUDA tensors into this manager's pinned buffers (appended to
        ``cuda``), other tensors cloned, arrays copied."""
        if isinstance(tree, dict):
            return {k: self._copy_off(v, f"{path}/{k}", cuda)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [self._copy_off(v, f"{path}/{n}", cuda)
                    for n, v in enumerate(tree)]
        if isinstance(tree, torch.Tensor) and tree.is_cuda:
            buf = self._pinned.get(path)
            if buf is None or buf.shape != tree.shape or \
                    buf.dtype != tree.dtype:
                buf = self._pinned[path] = torch.empty(
                    tree.shape, dtype=tree.dtype, pin_memory=True)
            buf.copy_(tree.detach(), non_blocking=True)
            cuda.append(path)
            return buf
        if isinstance(tree, torch.Tensor):
            return tree.detach().clone()
        if isinstance(tree, np.ndarray):
            return tree.copy()
        return tree

    def wait(self, raise_errors: bool = True) -> None:
        """Join any in-flight async write; re-raise its failure (unless
        ``raise_errors=False``, as restore does: a failed newer write must
        not mask recovery from an older intact snapshot)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_err is not None:
            err, self._writer_err = self._writer_err, None
            if raise_errors:
                raise err
            logger.warning(
                "ignoring failed async checkpoint write during restore: %s",
                err)

    def _steps(self) -> List[int]:
        steps = []
        for fn in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", fn)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def all_steps(self) -> List[int]:
        with self._fs_lock:
            return self._steps()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _quarantine(self, step: int, err: BaseException) -> None:
        """Move a torn or corrupt snapshot out of the recovery set (kept
        on disk for a post-mortem, renamed so it is never restored)."""
        path = self._path(step)
        try:
            with self._fs_lock:
                os.replace(path, path + ".corrupt")
        except OSError:
            pass
        obs.count("checkpoint_total", op="restore", status="quarantined",
                  flat="robust/ckpt_quarantined")
        logger.warning("checkpoint step %d is corrupt (%s: %s); quarantined "
                       "as %s.corrupt — falling back to an older snapshot",
                       step, type(err).__name__, err, os.path.basename(path))

    def restore(self, step: Optional[int] = None) -> Tuple[int, Any]:
        """Load a snapshot, verifying integrity (``verify``).

        With ``step=None`` (latest), torn or corrupt snapshots are
        quarantined and the newest intact one wins; corruption is fatal
        only when nothing intact remains.  An explicitly requested step
        is loaded strictly: its corruption raises."""
        self.wait(raise_errors=False)
        t0 = time.perf_counter()
        try:
            if step is not None:
                tree = load_pytree(self._path(step), verify=self.verify)
                found = step
            else:
                steps = self.all_steps()
                if not steps:
                    raise FileNotFoundError(
                        f"no checkpoints in {self.directory}")
                found = None
                for s in reversed(steps):
                    try:
                        tree = load_pytree(self._path(s), verify=self.verify)
                        found = s
                        break
                    except KeyboardInterrupt:
                        raise
                    except Exception as e:
                        # a torn zip, a CRC mismatch: every flavour of
                        # "this file is not a usable snapshot"
                        self._quarantine(s, e)
                if found is None:
                    raise FileNotFoundError(
                        f"no intact checkpoints in {self.directory} "
                        f"({len(steps)} candidate(s) quarantined)")
        except BaseException:
            obs.count("checkpoint_total", op="restore", status="error")
            raise
        obs.observe("checkpoint_seconds", time.perf_counter() - t0,
                    flat="checkpoint/restore", op="restore")
        obs.count("checkpoint_total", op="restore", status="ok")
        return found, tree

    def _gc(self) -> None:
        with self._fs_lock:
            steps = self._steps()
            for s in steps[: max(0, len(steps) - self.keep)]:
                try:
                    os.unlink(self._path(s))
                except OSError:
                    pass
