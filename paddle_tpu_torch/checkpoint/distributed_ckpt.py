"""Step checkpoints with integrity and auto-resume (counterpart of
``paddle_tpu/checkpoint/distributed_ckpt.py``; reference:
python/paddle/distributed/checkpoint/save_state_dict.py + load_state_dict,
and PaddleNLP's unified-checkpoint auto-resume).

The JAX package writes each step through orbax. The port has no orbax,
so the step files are in a format of its own, and the JAX package's
orbax checkpoints cannot be read here (nor these there):

    <dir>/<step>/index.json    {"format": FORMAT, "tree": ...}: the saved
                               nested dict, each tensor replaced by
                               {"__tensor__": "t00012", "dtype":
                               "bfloat16", "shape": [...], "pieces":
                               [{"file": "r1/t00012.0.bin", "index":
                               [[lo, hi], ...]}, ...]}, other leaves
                               (numbers, strings, None) kept as JSON
    <dir>/<step>/r<k>/t00012.<j>.bin  a piece of the tensor that rank k
                               wrote: the elements of its box of the
                               logical tensor, raw, little-endian, in the
                               tensor's own dtype (bf16 and fp16 too)
    <dir>/manifests/<step>.json  sha256 and size of every file of the
                               step, every rank's
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

On a mesh (``torch.distributed`` initialised) every rank calls ``save``
at the same step and writes the pieces it owns, no tensor gathered: a
``DTensor`` leaf's local shard as the boxes of the logical tensor it
covers (a fused projection's strided shard as one box a block), and a
replicated tensor (or a plain one) by its lowest holder alone, the rank
at coordinate 0 of every mesh axis that does not split it. Each rank
hashes its own files; their digests and boxes reach rank 0 over a gloo
group of the module's own (a gather: the barrier that every rank's write
is durable), and rank 0 then writes the index, commits the step and
writes the manifest and the sidecar. ``restore(like=...)`` reads, for a
``DTensor`` leaf of ``like``, only the pieces that overlap this rank's
shard, and returns that shard; without ``like`` (or for a plain leaf)
the whole tensor, reassembled. So a step saved on one mesh resumes on
another (another dp degree, fsdp and tp splits, a world of one). Steps
in the earlier layout (``paddle_tpu_torch.step/1``: rank 0 wrote whole
tensors, ``<step>/t00012.bin``) restore as one piece a tensor. A save
with ``wait`` returns on every rank once the step is committed, and the
trainer makes every rank wait for the commit before a resume reads it.
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

FORMAT = "paddle_tpu_torch.step/2"
# the layout before per-rank pieces: rank 0 wrote every tensor whole
FORMAT_WHOLE = "paddle_tpu_torch.step/1"
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


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _boxes(idx):
    """(local box, global box) pairs of a ``local_index``: a strided dim's
    blocks each a box of their own, laid end to end in the local
    shard."""
    out = [((), ())]
    for e in idx:
        parts = e if isinstance(e, tuple) else (e,)
        step, opts = 0, []
        for g in parts:
            n = g.stop - g.start
            opts.append((slice(step, step + n), g))
            step += n
        out = [(lb + (lo,), gb + (go,)) for lb, gb in out for lo, go in opts]
    return out


def _owned_pieces(t: torch.Tensor):
    """The (local box, global box) pieces of tensor ``t`` that this rank
    writes: a DTensor's local shard where this rank is its lowest holder
    (coordinate 0 of every mesh axis that does not split it), a plain
    tensor on rank 0; nothing otherwise."""
    from ..parallel.sharding import is_sharded, local_index, split_of
    if not is_sharded(t):
        whole = tuple(slice(0, n) for n in t.shape)
        return [(whole, whole)] if _rank() == 0 else []
    mesh = t.device_mesh
    for pl, n, c in zip(t.placements, mesh.mesh.shape,
                        mesh.get_coordinate()):
        if split_of(pl) is None and n > 1 and c != 0:
            return []
    return _boxes(local_index(t))


def _flatten(tree, pieces: List[Tuple[str, torch.Tensor, list]],
             names: List[str]):
    """The tree as JSON with each tensor replaced by its entry (no pieces
    yet: rank 0 adds every rank's; ``names`` collects the entries' ids);
    the pieces this rank writes are appended to ``pieces`` as (entry id,
    host copy, global box)."""
    if isinstance(tree, dict):
        return {str(k): _flatten(v, pieces, names) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, pieces, names) for v in tree]
    if torch.is_tensor(tree):
        from ..parallel.sharding import local
        t = tree.detach()
        if t.dtype not in _DTYPES.values():
            raise TypeError(f"cannot checkpoint a {t.dtype} tensor")
        name = f"t{len(names):05d}"
        names.append(name)
        for lbox, gbox in _owned_pieces(t):
            host = local(t)[lbox].to("cpu", copy=True).contiguous()
            pieces.append((name, host, [[g.start, g.stop] for g in gbox]))
        return {_TENSOR: name, "dtype": str(t.dtype).replace("torch.", ""),
                "shape": list(t.shape)}
    if isinstance(tree, np.generic):
        return tree.item()
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree)}")


def _barrier():
    """Every rank of an initialised process group (nothing alone)."""
    from ..distributed.env import barrier
    barrier()


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
        if not isinstance(got, (torch.Tensor, _Meta)) or \
                got.dtype != like.dtype or \
                tuple(got.shape) != tuple(like.shape):
            desc = (f"{got.dtype} {tuple(got.shape)}"
                    if isinstance(got, (torch.Tensor, _Meta))
                    else type(got).__name__)
            raise ValueError(f"{path}: {desc} != {like.dtype} "
                             f"{tuple(like.shape)}")


class _Entries(dict):
    """A saved tree's index read as the tree it describes, for
    :func:`_check_like`: each tensor entry stands for a tensor of its
    dtype and logical shape."""

    def __init__(self, tree):
        super().__init__({k: _entry_view(v) for k, v in tree.items()})


class _Meta:
    def __init__(self, entry):
        self.dtype = _DTYPES[entry["dtype"]]
        self.shape = tuple(entry["shape"])


def _entry_view(node):
    if isinstance(node, dict):
        return _Meta(node) if _TENSOR in node else _Entries(node)
    if isinstance(node, list):
        return [_entry_view(v) for v in node]
    return node


# raw views of a piece file by element size (bf16 and fp16 as int16)
_RAW = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


def _read_region(d: str, entry, like) -> torch.Tensor:
    """The tensor ``entry`` describes, or this rank's shard of it when
    ``like`` is a ``DTensor``: each box of the shard filled from the
    pieces that overlap it, each piece file read through a memory map
    (only the rows it is indexed by). A step in the earlier layout has
    one piece a tensor, the whole of it."""
    from ..parallel.sharding import is_sharded, local_index
    dtype = _DTYPES[entry["dtype"]]
    shape = tuple(entry["shape"])
    whole = [[0, n] for n in shape]
    pieces = entry.get("pieces")
    if pieces is None:
        pieces = [{"file": entry[_TENSOR], "index": whole}]
    idx = (local_index(like) if is_sharded(like)
           else tuple(slice(0, n) for n in shape))
    out = torch.empty([sum(g.stop - g.start for g in
                           (e if isinstance(e, tuple) else (e,)))
                       for e in idx], dtype=dtype)
    raw = _RAW[torch.empty((), dtype=dtype).element_size()]
    for lbox, gbox in _boxes(idx):
        for piece in pieces:
            box = piece["index"]
            cut = [(max(g.start, lo), min(g.stop, hi))
                   for g, (lo, hi) in zip(gbox, box)]
            if any(a >= b for a, b in cut):
                continue
            pshape = tuple(hi - lo for lo, hi in box)
            path = os.path.join(d, piece["file"])
            arr = (np.fromfile(path, dtype=raw).reshape(pshape)
                   if not pshape or 0 in pshape else
                   np.memmap(path, dtype=raw, mode="r", shape=pshape))
            src = tuple(slice(a - lo, b - lo)
                        for (a, b), (lo, _) in zip(cut, box))
            dst = tuple(slice(lb.start + a - g.start, lb.start + b - g.start)
                        for (a, b), g, lb in zip(cut, gbox, lbox))
            out[dst] = torch.from_numpy(
                np.array(arr[src])).view(dtype)
    return out


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
        self._ranks_group = None

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
        for root, _, names in os.walk(d):
            for name in names:
                p = os.path.join(root, name)
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
        """Copy this rank's pieces of ``state`` (a nested dict of tensors
        and plain values) to host memory, then write them as step
        ``step``: in the background unless ``wait`` (or
        ``async_save=False``), in which case the step is committed, its
        manifest written, on every rank's return. ``meta``
        (JSON-serialisable) is written to the step's sidecar by rank 0
        once every rank's files are durable."""
        t0 = time.perf_counter()
        self._join_writer()
        group = self._group()
        pieces: List[Tuple[str, torch.Tensor, list]] = []
        index = {"format": FORMAT, "tree": _flatten(state, pieces, [])}
        snapshot_s = time.perf_counter() - t0
        durable = wait or not self.async_save
        # what this rank copied to host memory: its own pieces only
        self.last_save = {"step": step, "snapshot_s": snapshot_s,
                          "bytes": sum(t.numel() * t.element_size()
                                       for _, t, _ in pieces)}
        args = (step, index, pieces, meta, group)
        if durable:
            self._write_step(*args)
            _barrier()
        else:
            self._writer = threading.Thread(
                target=self._write_step_logged, args=args,
                name=f"ckpt-writer-{step}", daemon=True)
            self._writer.start()
        save_ms = (time.perf_counter() - t0) * 1e3
        obs.histogram("ckpt_save_ms").observe(save_ms)
        obs.record_event("ckpt_save", step=step, wait=wait,
                         ms=round(save_ms, 3))

    def _group(self):
        """The gloo group the ranks' digests travel over (made at the
        first save on a world of several ranks: every rank saves), or
        None alone."""
        import torch.distributed as dist
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return None
        if self._ranks_group is None:
            self._ranks_group = dist.new_group(backend="gloo")
        return self._ranks_group

    def _write_step_logged(self, *args):
        try:
            self._write_step(*args)
        except BaseException as e:     # surfaced by the next join
            self._writer_error = e

    def _write_step(self, step: int, index, pieces, meta, group):
        """This rank's pieces into ``<step>.partial/r<rank>/``, hashed;
        the digests and boxes gathered to rank 0, which writes the
        index, commits the step, writes the manifest and the sidecar."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        final = self._step_dir(step)
        tmp = final + ".partial"
        rank = _rank()
        sub = f"r{rank}"
        shutil.rmtree(os.path.join(tmp, sub), ignore_errors=True)
        os.makedirs(os.path.join(tmp, sub))
        counts: Dict[str, int] = {}

        def named(piece):
            name, _, box = piece
            j = counts[name] = counts.get(name, -1) + 1
            return f"{sub}/{name}.{j}.bin", piece
        jobs = [named(q) for q in pieces]

        def write(job):
            rel, (name, t, box) = job
            data = _bytes_of(t)
            with open(os.path.join(tmp, rel), "wb") as f:
                f.write(data)
            return name, rel, box, {"sha256": hashlib.sha256(data)
                                    .hexdigest(), "size": data.nbytes}
        with ThreadPoolExecutor(IO_THREADS) as pool:
            mine = list(pool.map(write, jobs))
        if group is not None:
            got = [None] * dist.get_world_size() if rank == 0 else None
            dist.gather_object(mine, got, dst=0, group=group)
        else:
            got = [mine]
        self.last_save["write_s"] = time.perf_counter() - t0
        if rank != 0:
            return
        where: Dict[str, list] = {}
        files = {}
        for written in got:
            for name, rel, box, digest in written:
                where.setdefault(name, []).append({"file": rel,
                                                   "index": box})
                files[rel] = digest

        def place(node):
            if isinstance(node, dict):
                if _TENSOR in node:
                    node["pieces"] = where.get(node[_TENSOR], [])
                else:
                    for v in node.values():
                        place(v)
            elif isinstance(node, list):
                for v in node:
                    place(v)
        place(index["tree"])
        raw = json.dumps(index).encode()
        with open(os.path.join(tmp, "index.json"), "wb") as f:
            f.write(raw)
        files["index.json"] = {"sha256": hashlib.sha256(raw).hexdigest(),
                               "size": len(raw)}
        if os.path.exists(final):    # a step saved again (preempt at a
            shutil.rmtree(final)     # save step): the newer bytes win
        os.replace(tmp, final)
        self._verify_memo.pop(step, None)
        if meta is not None:
            try:
                self._write_meta(step, meta)
            except (OSError, TypeError, ValueError) as e:
                print(f"[ckpt] meta sidecar for step {step} failed: {e}",
                      file=sys.stderr, flush=True)
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
        dtype and logical shape (ValueError otherwise); where ``like``
        holds a ``DTensor``, the restored leaf is this rank's shard of
        it, read from the pieces that overlap it alone.

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
            out = self._restore_step(s, like)
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

    def _restore_step(self, step: int, like=None):
        d = self._step_dir(step)
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        if index.get("format") not in (FORMAT, FORMAT_WHOLE):
            raise ValueError(f"{d}: format {index.get('format')!r}, "
                             f"expected {FORMAT!r}")
        if like is not None:
            _check_like(_Entries(index["tree"]), like)
        jobs = []

        def plan(node, want):
            if isinstance(node, dict):
                if _TENSOR in node:
                    jobs.append((node, want))
                    return
                for k, v in node.items():
                    plan(v, want.get(k) if isinstance(want, dict) else None)
            elif isinstance(node, list):
                for i, v in enumerate(node):
                    plan(v, want[i] if isinstance(want, (list, tuple))
                         else None)
        plan(index["tree"], like)
        with ThreadPoolExecutor(IO_THREADS) as pool:
            loaded = dict(pool.map(lambda job: (id(job[0]),
                                                _read_region(d, *job)), jobs))

        def build(node):
            if isinstance(node, dict):
                if _TENSOR in node:
                    return loaded[id(node)]
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
