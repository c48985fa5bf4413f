"""The host runtime (counterpart of ``paddle_tpu/native``; reference:
Paddle's C++ core: BlockingQueue, DataLoader workers, pinned staging
allocator): ctypes bindings over a small C++ library that feeds the card
from host memory.

The library is built from ``native/src/runtime.cc`` and ``src/bpe.cc`` at
first use, with the host compiler (``$CXX``, else ``g++``) and
:data:`CXX_FLAGS`, into ``paddle_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the sources, the compiler and the
flags, so an edited source is rebuilt and an unchanged one reused. A
failed build raises with the compiler's output whenever a native path is
asked for: nothing here gives way to Python in silence.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
SOURCES = ("runtime.cc", "bpe.cc")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
             "-fvisibility=hidden")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}
# seconds the last build in this process took (0.0 when one was reused)
build_seconds = 0.0


def compiler() -> list:
    """The host compiler command: ``$CXX`` (split as a shell would),
    else ``g++``."""
    return shlex.split(os.environ.get("CXX") or "g++")


def _target(cxx: list) -> Path:
    h = hashlib.sha256(" ".join(cxx + list(CXX_FLAGS)).encode())
    for name in SOURCES:
        h.update((SRC / name).read_bytes())
    return BUILD_DIR / f"libpaddle_tpu_torch_native-{h.hexdigest()[:16]}.so"


def _build(cxx: list, target: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = cxx + list(CXX_FLAGS) + ["-o", str(tmp)] + [
        str(SRC / n) for n in SOURCES]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native runtime build failed: {' '.join(cmd)}"
                           f"\n{e}") from e
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native runtime build failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    build_seconds = time.perf_counter() - t0


def _bind(lib):
    c = ctypes
    u64, sz, vp = c.c_uint64, c.c_size_t, c.c_void_p
    sigs = {
        "pt_arena_create": ([sz], vp),
        "pt_arena_alloc": ([vp, sz], vp),
        "pt_arena_reset": ([vp], None),
        "pt_arena_used": ([vp], sz),
        "pt_arena_destroy": ([vp], None),
        "pt_pool_create": ([c.c_int], vp),
        "pt_pool_destroy": ([vp], None),
        "pt_pool_size": ([vp], c.c_int),
        "pt_gather_stack": ([vp, c.POINTER(vp), sz, sz, vp], None),
        "pt_gather_pad": ([vp, c.POINTER(vp), c.POINTER(sz), sz, sz, sz,
                           vp, vp], None),
        "pt_ring_create": ([sz], vp),
        "pt_ring_destroy": ([vp], None),
        "pt_ring_push": ([vp, u64, c.c_int], c.c_int),
        "pt_ring_pop": ([vp, c.POINTER(u64), c.c_int], c.c_int),
        "pt_ring_close": ([vp], None),
        "pt_ring_size": ([vp], sz),
        "pt_tok_create": ([c.c_char_p, sz, c.c_int32], vp),
        "pt_tok_destroy": ([vp], None),
        "pt_tok_vocab_size": ([vp], sz),
        "pt_tok_encode": ([vp, c.c_char_p, sz, c.POINTER(c.c_int32), sz], sz),
        "pt_tok_encode_batch": ([vp, vp, c.c_char_p, c.POINTER(sz), sz,
                                 c.POINTER(c.c_int32), sz, c.c_int32,
                                 c.POINTER(sz)], None),
        "pt_bpe_create": ([c.c_int32, c.c_char_p, c.POINTER(c.c_int32),
                           c.POINTER(c.c_int32), c.c_int32, c.c_int32,
                           c.POINTER(c.c_int32), c.POINTER(c.c_int32),
                           c.POINTER(c.c_int32)], vp),
        "pt_bpe_destroy": ([vp], None),
        "pt_bpe_encode_words": ([vp, c.c_char_p, c.POINTER(c.c_int32),
                                 c.c_int32, c.POINTER(c.c_int32),
                                 c.c_int64, c.POINTER(c.c_int32)],
                                c.c_int64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def lib() -> ctypes.CDLL:
    """The loaded native library, built with the current ``$CXX`` at the
    first call. Raises ``RuntimeError`` with the compiler's output when
    the build fails."""
    cxx = compiler()
    target = _target(cxx)
    found = _libs.get(target)
    if found is not None:
        return found
    with _lock:
        if target not in _libs:
            if not target.exists():
                _build(cxx, target)
            _libs[target] = _bind(ctypes.CDLL(str(target)))
        return _libs[target]


def available() -> bool:
    """True once the library is built and loaded. A failed build raises
    (the JAX package's ``available()`` returns False there and its
    callers take pure-Python paths; the port has none)."""
    return lib() is not None


class ThreadPool:
    """Native pthread pool handle."""

    def __init__(self, num_threads: int = 0):
        self._lib = lib()
        self._h = self._lib.pt_pool_create(num_threads or (os.cpu_count()
                                                           or 4))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pt_pool_destroy(self._h)
            self._h = None


class StagingArena:
    """Page-aligned host staging arena: batches assembled here are handed
    to the host-to-device copy."""

    def __init__(self, capacity_bytes: int = 1 << 28):
        self._lib = lib()
        self._h = self._lib.pt_arena_create(capacity_bytes)
        if not self._h:
            raise MemoryError(f"arena of {capacity_bytes} bytes")
        self.capacity = capacity_bytes

    def alloc(self, nbytes: int, dtype, shape):
        """Allocate a numpy view inside the arena (no copy on reset)."""
        ptr = self._lib.pt_arena_alloc(self._h, nbytes)
        if not ptr:
            raise MemoryError("staging arena exhausted; call reset()")
        buf = (ctypes.c_char * nbytes).from_address(ptr)
        # the view's base chain holds `buf`; pinning the arena on it keeps
        # the slab alive as long as ANY view exists (prefetch queues hand
        # views to other threads after this thread's locals are gone)
        buf._arena_ref = self
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def used(self) -> int:
        return self._lib.pt_arena_used(self._h)

    def reset(self):
        """Recycle the slab (invalidates prior views: only call once the
        previous step's host-to-device copy has completed)."""
        self._lib.pt_arena_reset(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pt_arena_destroy(self._h)
            self._h = None


def gather_stack(pool: ThreadPool, items, arena: StagingArena | None = None):
    """Parallel np.stack of same-shape contiguous arrays via the native
    pool. With an arena, the batch lands in staging memory."""
    items = [np.ascontiguousarray(a) for a in items]
    first = items[0]
    if any(a.shape != first.shape or a.dtype != first.dtype
           for a in items[1:]):
        raise ValueError("gather_stack needs same-shape/dtype items "
                         "(like np.stack)")
    n = len(items)
    out_shape = (n,) + first.shape
    nbytes = first.nbytes * n
    if arena is not None:
        dst = arena.alloc(nbytes, first.dtype, out_shape)
    else:
        dst = np.empty(out_shape, first.dtype)
    srcs = (ctypes.c_void_p * n)(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in items])
    pool._lib.pt_gather_stack(pool._h, srcs, n, first.nbytes,
                              dst.ctypes.data_as(ctypes.c_void_p))
    return dst


def gather_pad(pool: ThreadPool, seqs, max_len: int, pad_value=0,
               dtype=np.int32, arena: StagingArena | None = None):
    """Ragged int sequences -> padded [n, max_len] batch (LLM collate)."""
    dtype = np.dtype(dtype)
    seqs = [np.ascontiguousarray(s, dtype=dtype) for s in seqs]
    n = len(seqs)
    if arena is not None:
        dst = arena.alloc(n * max_len * dtype.itemsize, dtype, (n, max_len))
    else:
        dst = np.empty((n, max_len), dtype)
    srcs = (ctypes.c_void_p * n)(
        *[s.ctypes.data_as(ctypes.c_void_p).value for s in seqs])
    lens = (ctypes.c_size_t * n)(*[len(s) for s in seqs])
    pad = np.asarray(pad_value, dtype)
    pool._lib.pt_gather_pad(pool._h, srcs, lens, n, max_len, dtype.itemsize,
                            pad.ctypes.data_as(ctypes.c_void_p),
                            dst.ctypes.data_as(ctypes.c_void_p))
    return dst


class Ring:
    """Blocking MPMC ring of u64 handles: prefetch handoff without the
    Python queue's lock contention. Values are opaque (indices into a
    Python-side slot table)."""

    def __init__(self, capacity: int):
        self._lib = lib()
        self._h = self._lib.pt_ring_create(capacity)

    def push(self, value: int, timeout_ms: int = -1) -> bool:
        r = self._lib.pt_ring_push(self._h, value, timeout_ms)
        if r == -1:
            raise TimeoutError("ring push timed out")
        return r == 1

    def pop(self, timeout_ms: int = -1):
        out = ctypes.c_uint64()
        r = self._lib.pt_ring_pop(self._h, ctypes.byref(out), timeout_ms)
        if r == -1:
            raise TimeoutError("ring pop timed out")
        return out.value if r == 1 else None

    def close(self):
        self._lib.pt_ring_close(self._h)

    def __len__(self):
        return self._lib.pt_ring_size(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pt_ring_destroy(self._h)
            self._h = None


class Tokenizer:
    """Greedy longest-match trie tokenizer over an id-ordered vocab list
    (tokenizer-lite: fast data prep without a Python inner loop)."""

    def __init__(self, vocab, unk_id: int = 0):
        self._lib = lib()
        if isinstance(vocab, (list, tuple)):
            blob = "\n".join(vocab).encode("utf-8")
        else:
            blob = vocab if isinstance(vocab, bytes) else str(vocab).encode()
        self._h = self._lib.pt_tok_create(blob, len(blob), unk_id)
        self.vocab_size = self._lib.pt_tok_vocab_size(self._h)

    def encode(self, text: str, max_len: int = 4096):
        raw = text.encode("utf-8")
        out = np.empty(max_len, np.int32)
        n = self._lib.pt_tok_encode(
            self._h, raw, len(raw),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_len)
        return out[:n].copy()

    def encode_batch(self, texts, pool: ThreadPool, max_len: int = 512,
                     pad_id: int = 0):
        raws = [t.encode("utf-8") for t in texts]
        blob = b"".join(raws)
        n = len(raws)
        offsets = np.zeros(n + 1, np.uintp)
        np.cumsum([len(r) for r in raws], out=offsets[1:])
        out = np.empty((n, max_len), np.int32)
        lens = np.empty(n, np.uintp)
        self._lib.pt_tok_encode_batch(
            self._h, pool._h, blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_len,
            pad_id, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)))
        return out, lens.astype(np.int64)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pt_tok_destroy(self._h)
            self._h = None
