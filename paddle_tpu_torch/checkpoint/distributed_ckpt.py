"""Step checkpoints with integrity and auto-resume (counterpart of
``paddle_tpu/checkpoint/distributed_ckpt.py``; reference:
python/paddle/distributed/checkpoint/save_state_dict.py + load_state_dict,
and PaddleNLP's unified-checkpoint auto-resume).

The JAX package writes each step through orbax. The port has no orbax,
so the step files are in a format of its own, and the JAX package's
orbax checkpoints cannot be read here (nor these there):

    <dir>/<step>/index.json    {"format": FORMAT, "tree": ...}: the saved
                               nested dict, each tensor replaced by
                               {"__tensor__": "t00012.bin", "dtype":
                               "bfloat16", "shape": [...]}, other leaves
                               (numbers, strings, None) kept as JSON
    <dir>/<step>/t00012.bin    the tensor's raw bytes, little-endian, in
                               its own dtype (bf16 and fp16 included)
    <dir>/manifests/<step>.json  sha256 and size of every file of the step
    <dir>/meta/<step>.json     the trainer's host-side sidecar (sampler
                               position, topology)

A step is written into ``<step>.partial`` and committed by renaming the
directory, so ``all_steps`` only ever lists complete steps. Saves are
asynchronous by default: ``save`` copies every tensor to host memory (the
train loop pays that copy; the update runs in place, so the snapshot
must be taken before the next step) and a writer thread writes the
files (several at once), commits, writes the manifest from the digests
of the bytes it wrote, and drops the oldest steps beyond ``max_to_keep``.
``wait_until_finished`` joins it; a new save first waits for the last.

Integrity, as in the JAX package: ``verify_step`` re-hashes a step's
files against its manifest (memoized per manifest mtime);
``latest_complete_step`` and ``restore`` skip a step that fails (bit
rot, a torn copy) and fall back to the next older one, and ``strict``
restores refuse instead. A step without a manifest is trusted. The
``ckpt_corrupt`` fault site flips bytes of a step right after its
manifest is written.

``restore`` returns the tree with CPU tensors; the trainer copies them
into its live tensors in place.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import faults
from ..utils import observability as obs

__all__ = ["DistributedCheckpoint", "CheckpointCorruptionError",
           "auto_resume", "FORMAT"]

FORMAT = "paddle_tpu_torch.step/1"
# files written, hashed or read at once (hashlib and file I/O release
# the GIL on large buffers)
IO_THREADS = 8
_TENSOR = "__tensor__"
_DTYPES = {str(d).replace("torch.", ""): d for d in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16,
    torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
    torch.bool)}


class CheckpointCorruptionError(RuntimeError):
    """Every on-disk checkpoint step failed checksum verification."""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _flatten(tree, tensors: List[torch.Tensor]):
    """The tree as JSON with each tensor replaced by its file entry; the
    tensors are appended to ``tensors`` as host copies."""
    if isinstance(tree, dict):
        return {str(k): _flatten(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, tensors) for v in tree]
    if torch.is_tensor(tree):
        t = tree.detach()
        if t.dtype not in _DTYPES.values():
            raise TypeError(f"cannot checkpoint a {t.dtype} tensor")
        host = t.to("cpu", copy=True).contiguous()
        entry = {_TENSOR: f"t{len(tensors):05d}.bin",
                 "dtype": str(t.dtype).replace("torch.", ""),
                 "shape": list(t.shape)}
        tensors.append(host)
        return entry
    if isinstance(tree, np.generic):
        return tree.item()
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree)}")


def _bytes_of(t: torch.Tensor) -> memoryview:
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def _check_like(got, like, path="state"):
    """Raise ValueError where ``got`` differs from ``like`` in structure,
    or a tensor in dtype or shape."""
    if isinstance(like, dict):
        if not isinstance(got, dict) or set(got) != set(like):
            have = sorted(got) if isinstance(got, dict) else type(got)
            raise ValueError(f"{path}: keys {have} != {sorted(like)}")
        for k in like:
            _check_like(got[k], like[k], f"{path}.{k}")
    elif torch.is_tensor(like):
        if not torch.is_tensor(got) or got.dtype != like.dtype or \
                tuple(got.shape) != tuple(like.shape):
            desc = (f"{got.dtype} {tuple(got.shape)}" if torch.is_tensor(got)
                    else type(got).__name__)
            raise ValueError(f"{path}: {desc} != {like.dtype} "
                             f"{tuple(like.shape)}")


class DistributedCheckpoint:
    """save(step, state) / restore(step | latest) over one directory."""

    MANIFEST_DIR = "manifests"
    META_DIR = "meta"

    def __init__(self, directory: str, max_to_keep: int = 5,
                 async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        # step -> (manifest mtime, verdict): hashing a big step is
        # seconds; latest_complete_step then restore must not pay twice
        self._verify_memo: Dict[int, Tuple[float, Optional[bool]]] = {}
        self.last_restored_step: Optional[int] = None
        # the last save's and restore's sizes and seconds (snapshot: the
        # host copy save() pays; write: files, commit and manifest)
        self.last_save: Dict[str, Any] = {}
        self.last_restore: Dict[str, Any] = {}

    # ------------------------------------------------------------- paths
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, self.MANIFEST_DIR,
                            f"{step}.json")

    def _meta_path(self, step: int) -> str:
        return os.path.join(self.directory, self.META_DIR, f"{step}.json")

    @staticmethod
    def _write_json(path: str, obj):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)

    # ---------------------------------------------------- meta sidecar
    def _write_meta(self, step: int, meta: Dict[str, Any]):
        """The step's host-side JSON sidecar (sampler position, topology),
        written atomically, outside the step's tensors."""
        self._write_json(self._meta_path(step), meta)

    def load_meta(self, step: int) -> Optional[Dict[str, Any]]:
        """The step's meta sidecar, or None (none written, or
        unreadable: resume then restores tensors only)."""
        try:
            with open(self._meta_path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # --------------------------------------------------------- integrity
    def _write_manifest(self, step: int, files: Dict[str, Dict[str, Any]]):
        """The committed step's per-file sha256 and size, written
        atomically; then the ``ckpt_corrupt`` chaos hook."""
        total = sum(f["size"] for f in files.values())
        obs.histogram("ckpt_bytes", buckets=obs.BYTES_BUCKETS).observe(total)
        obs.record_event("ckpt_committed", step=step, bytes=total,
                         files=len(files))
        self._write_json(self._manifest_path(step),
                         {"step": step, "files": files})
        # chaos: corrupt the step AFTER its manifest committed, so
        # verification sees exactly what bit rot would produce
        if faults.inject("ckpt_corrupt", step=step):
            self._corrupt_step(step)

    def _corrupt_step(self, step: int):
        """Deterministically flip 16 bytes in the middle of the step's
        largest file."""
        d = self._step_dir(step)
        largest, size = None, -1
        for name in os.listdir(d):
            p = os.path.join(d, name)
            s = os.path.getsize(p)
            if s > size:
                largest, size = p, s
        if largest is None:
            return
        with open(largest, "r+b") as f:
            f.seek(size // 2)
            chunk = f.read(16) or b"\0"
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))

    def verify_step(self, step: int) -> Optional[bool]:
        """True: the checksums match; False: corruption; None: no
        manifest (trusted)."""
        self._join_writer()
        mpath = self._manifest_path(step)
        if not os.path.exists(mpath):
            self._verify_memo.pop(step, None)
            return None
        mtime = os.path.getmtime(mpath)
        memo = self._verify_memo.get(step)
        if memo is not None and memo[0] == mtime:
            return memo[1]
        verdict = self._verify_step_uncached(step)
        self._verify_memo[step] = (mtime, verdict)
        return verdict

    def _verify_step_uncached(self, step: int) -> Optional[bool]:
        try:
            with open(self._manifest_path(step)) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None          # unreadable manifest: treat as absent
        d = self._step_dir(step)

        def ok(item):
            rel, info = item
            p = os.path.join(d, rel)
            return (os.path.exists(p) and os.path.getsize(p) == info["size"]
                    and _sha256(p) == info["sha256"])
        with ThreadPoolExecutor(IO_THREADS) as pool:
            return all(pool.map(ok, manifest.get("files", {}).items()))

    # ------------------------------------------------------------ save
    def save(self, step: int, state: Dict[str, Any], wait: bool = False,
             meta: Optional[Dict[str, Any]] = None):
        """Copy ``state`` (a nested dict of tensors and plain values) to
        host memory, then write it as step ``step``: in the background
        unless ``wait`` (or ``async_save=False``), in which case the
        files, the commit and the manifest are durable on return. ``meta``
        (JSON-serialisable) is written at once to the step's sidecar."""
        t0 = time.perf_counter()
        self._join_writer()
        tensors: List[torch.Tensor] = []
        index = {"format": FORMAT, "tree": _flatten(state, tensors)}
        snapshot_s = time.perf_counter() - t0
        if meta is not None:
            try:
                self._write_meta(step, meta)
            except (OSError, TypeError, ValueError) as e:
                print(f"[ckpt] meta sidecar for step {step} failed: {e}",
                      file=sys.stderr, flush=True)
        self.last_save = {"step": step, "snapshot_s": snapshot_s,
                          "bytes": sum(t.numel() * t.element_size()
                                       for t in tensors)}
        if wait or not self.async_save:
            self._write_step(step, index, tensors)
        else:
            self._writer = threading.Thread(
                target=self._write_step_logged, args=(step, index, tensors),
                name=f"ckpt-writer-{step}", daemon=True)
            self._writer.start()
        save_ms = (time.perf_counter() - t0) * 1e3
        obs.histogram("ckpt_save_ms").observe(save_ms)
        obs.record_event("ckpt_save", step=step, wait=wait,
                         ms=round(save_ms, 3))

    def _write_step_logged(self, step, index, tensors):
        try:
            self._write_step(step, index, tensors)
        except BaseException as e:     # surfaced by the next join
            self._writer_error = e

    def _write_step(self, step: int, index, tensors):
        t0 = time.perf_counter()
        final = self._step_dir(step)
        tmp = final + ".partial"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)

        def write(i):
            name = f"t{i:05d}.bin"
            data = _bytes_of(tensors[i])
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(data)
            return name, {"sha256": hashlib.sha256(data).hexdigest(),
                          "size": data.nbytes}
        with ThreadPoolExecutor(IO_THREADS) as pool:
            files = dict(pool.map(write, range(len(tensors))))
        raw = json.dumps(index).encode()
        with open(os.path.join(tmp, "index.json"), "wb") as f:
            f.write(raw)
        files["index.json"] = {"sha256": hashlib.sha256(raw).hexdigest(),
                               "size": len(raw)}
        if os.path.exists(final):    # a step saved again (preempt at a
            shutil.rmtree(final)     # save step): the newer bytes win
        os.replace(tmp, final)
        self._verify_memo.pop(step, None)
        try:
            self._write_manifest(step, files)
        except OSError as e:         # the manifest is best-effort
            print(f"[ckpt] manifest for step {step} failed: {e}",
                  file=sys.stderr, flush=True)
        self._evict()
        self.last_save["write_s"] = time.perf_counter() - t0

    def _evict(self):
        """Drop the oldest steps beyond ``max_to_keep``, and the manifests
        and sidecars of steps that no longer exist."""
        steps = sorted(self.all_steps())
        for s in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        live = set(self.all_steps())
        for sub in (self.MANIFEST_DIR, self.META_DIR):
            mdir = os.path.join(self.directory, sub)
            if not os.path.isdir(mdir):
                continue
            for name in os.listdir(mdir):
                stem = name.split(".")[0]
                # a sidecar is written before its step commits: only an
                # older step's is an orphan
                if stem.isdigit() and int(stem) not in live and \
                        int(stem) < max(live, default=-1):
                    try:
                        os.remove(os.path.join(mdir, name))
                    except OSError:
                        pass

    def _join_writer(self):
        w = self._writer
        if w is not None:
            w.join()
            self._writer = None
        if self._writer_error is not None:
            err, self._writer_error = self._writer_error, None
            raise RuntimeError("the asynchronous checkpoint write "
                               "failed") from err

    # --------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None,
                like: Optional[Dict[str, Any]] = None,
                strict: bool = False) -> Dict[str, Any]:
        """The tree of step ``step`` (default: the latest complete and
        verified one) with CPU tensors. ``like`` (a tree of the same
        structure) is checked against it: the same keys, each tensor's
        dtype and shape (ValueError otherwise).

        A step that fails checksum verification falls back to the next
        older one that passes (a warning on stderr);
        ``last_restored_step`` records the step actually loaded.
        ``strict=True`` refuses instead for an explicitly requested step
        (CheckpointCorruptionError); with no verified step at all the same
        error is raised either way."""
        self._join_writer()
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            raise FileNotFoundError(
                f"no complete checkpoint in {self.directory}")
        if step is None:
            candidates = steps
        elif step in steps:
            candidates = [step] + [s for s in steps if s < step]
        else:
            raise FileNotFoundError(
                f"no complete checkpoint for step {step} in "
                f"{self.directory}")
        for s in candidates:
            if self.verify_step(s) is False:
                if strict and step is not None:
                    raise CheckpointCorruptionError(
                        f"checkpoint step {s} failed checksum "
                        f"verification (strict restore)")
                print(f"[ckpt] step {s} failed checksum verification; "
                      f"falling back to an older checkpoint",
                      file=sys.stderr, flush=True)
                continue
            t0 = time.perf_counter()
            out = self._restore_step(s)
            if like is not None:
                _check_like(out, like)
            self.last_restored_step = s
            restore_s = time.perf_counter() - t0
            self.last_restore = {"step": s, "read_s": restore_s}
            obs.histogram("ckpt_restore_ms").observe(restore_s * 1e3)
            obs.record_event("ckpt_restore", step=s,
                             ms=round(restore_s * 1e3, 3))
            return out
        raise CheckpointCorruptionError(
            f"every checkpoint step in {self.directory} failed checksum "
            f"verification ({candidates})")

    def _restore_step(self, step: int):
        d = self._step_dir(step)
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        if index.get("format") != FORMAT:
            raise ValueError(f"{d}: format {index.get('format')!r}, "
                             f"expected {FORMAT!r}")
        entries = []

        def collect(node):
            if isinstance(node, dict):
                if _TENSOR in node:
                    entries.append(node)
                else:
                    for v in node.values():
                        collect(v)
            elif isinstance(node, list):
                for v in node:
                    collect(v)
        collect(index["tree"])

        def read(e):
            raw = np.fromfile(os.path.join(d, e[_TENSOR]), dtype=np.uint8)
            t = torch.from_numpy(raw).view(_DTYPES[e["dtype"]])
            return e[_TENSOR], t.reshape(e["shape"])
        with ThreadPoolExecutor(IO_THREADS) as pool:
            loaded = dict(pool.map(read, entries))

        def build(node):
            if isinstance(node, dict):
                if _TENSOR in node:
                    return loaded[node[_TENSOR]]
                return {k: build(v) for k, v in node.items()}
            if isinstance(node, list):
                return [build(v) for v in node]
            return node
        return build(index["tree"])

    def latest_complete_step(self) -> Optional[int]:
        """The newest step that is committed and passes verification."""
        self._join_writer()
        for step in sorted(self.all_steps(), reverse=True):
            if self.verify_step(step) is not False:
                return step
        return None

    def all_steps(self) -> List[int]:
        return [int(n) for n in os.listdir(self.directory)
                if n.isdigit()
                and os.path.isdir(os.path.join(self.directory, n))]

    def wait_until_finished(self):
        self._join_writer()

    def close(self):
        self._join_writer()


def auto_resume(directory: str, state: Dict[str, Any]):
    """(state, start_step): the latest complete and verified checkpoint (a
    corrupt latest is skipped) with CPU tensors, checked against
    ``state``'s structure, and its step + 1; or ``state`` and 0 when there
    is none (PaddleNLP Trainer's resume_from_checkpoint=True)."""
    ckpt = DistributedCheckpoint(directory)
    step = ckpt.latest_complete_step()
    if step is None:
        ckpt.close()
        return state, 0
    restored = ckpt.restore(step, like=state)
    ckpt.close()
    return restored, step + 1
