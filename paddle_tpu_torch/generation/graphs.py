"""CUDA graphs of decode programs, shared by ``PagedEngine``'s ticks and
``generate()``'s steps (the port's counterpart of the JAX package's
jitted loops: one compiled program, replayed).

A program here is a function with no arguments over fixed device
buffers: it reads its state from them and writes its results back with
``copy_`` and in-place ops, so a graph captured once replays the next
step at whatever the buffers hold. What a capture freezes, and what
this module keeps true about it:

- the weights' addresses: :func:`weights_links` records them and
  :func:`weights_moved` says when a module, parameter or buffer was
  replaced or moved (weights quantized in place), or a forward hook
  added or removed (a LoRA adapter merged: its hook's captured delta
  must not replay over the merged weight), after which the graphs must
  be dropped;
- the kernels' workspaces: the graph keeps alive every one its capture
  was handed (``keeping_workspaces``), so a workspace grown later never
  frees memory a graph still writes;
- the launch counts: the wrappers' launches made while capturing do not
  run; they are counted into the graph's record and added to the
  wrappers' counters at each replay.

The capture holds ``device.card_lock`` alone. On the CPU a program runs
eagerly, as it does on a card inside :func:`eager_steps`.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import weakref
from collections import OrderedDict
from collections.abc import Mapping
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from ..device import card_lock
from ..ops.kernels import (add_launches, capturing_launches,
                           keeping_workspaces)

__all__ = ["TickGraph", "capture", "weights_links", "weights_moved",
           "CapturedStep", "DecodeProgram", "ExecCache", "exec_cache_for",
           "eager_steps", "buffer_bytes"]


class TickGraph(NamedTuple):
    """A captured program: the graph, the launches its capture counted
    ({wrapper: (launches, by route)}, added at each replay), and the
    kernel workspaces it writes, kept alive with it."""
    graph: Any
    launches: Dict[Any, tuple]
    keep: List[Any]


def capture(fn: Callable[[], None], device: torch.device, pool):
    """Run ``fn`` once eagerly (it is a real step: it also warms up what
    must not happen inside a capture, such as kernel builds, workspaces
    and library handles), then capture it into a CUDA graph in ``pool``.
    Returns (``TickGraph``, bytes the capture reserved).

    The warm-up runs on a side stream that first waits for the current
    one (on the current stream, the int8 tick's graph gave other streams
    than its eager program). The capture holds ``card_lock`` alone, so
    no other thread launches meanwhile (they share the kernels'
    workspaces), and runs in ``thread_local`` mode: another thread's CUDA
    calls meanwhile (a profiler's synchronize) do not invalidate it. The
    garbage collector runs before the capture and not during it: a graph
    freed inside a capture (a dead model's program, a cycle only the
    collector frees) invalidates the capture."""
    with card_lock.exclusive():
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        # the graph's node list is kept for inspection (chip_smoke.py
        # counts its kernels by name)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with capturing_launches() as captured, \
                    keeping_workspaces() as kept:
                with torch.cuda.graph(graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    fn()
        finally:
            if collecting:
                gc.enable()
        graph.instantiate()
        grown = torch.cuda.memory_reserved(device) - reserved
    return TickGraph(graph, captured, list(kept.values())), grown


def _address(v) -> int:
    """A tensor's address (a DTensor's: its local shard's), else 0."""
    if not torch.is_tensor(v):
        return 0
    return getattr(v, "_local_tensor", v).data_ptr()


def _bound(mod) -> dict:
    """The tensors bound over ``mod``'s parameters (a sharded model's
    compute tensors, ``parallel.sharding.bind``), by name."""
    return {k: mod.__dict__[k] for k in mod._parameters
            if k in mod.__dict__}


def weights_links(model):
    """What a graph froze of ``model``: each submodule, parameter,
    buffer and bound compute tensor slot as (its dict, name, a weak
    reference to the value, the tensor's address), and the size of each
    of those dicts and of each module's forward (pre-)hooks."""
    links, sizes = [], []
    for mod in model.modules():
        for d in (mod._forward_hooks, mod._forward_pre_hooks):
            sizes.append((d, len(d)))
        for d in (mod._modules, mod._parameters, mod._buffers):
            sizes.append((d, len(d)))
            for k, v in d.items():
                links.append((d, k, None if v is None else weakref.ref(v),
                              _address(v)))
        for k, v in _bound(mod).items():
            links.append((mod.__dict__, k, weakref.ref(v), _address(v)))
    return links, sizes


def weights_moved(recorded) -> bool:
    """True when a module, parameter or buffer of the model was replaced
    or moved, or a module gained or lost a forward hook, since
    ``recorded`` (:func:`weights_links`): its graphs would read stale,
    perhaps freed, memory, or replay a hook's captured work. A check of
    identities, cheaper than walking ``parameters()``."""
    links, sizes = recorded
    for d, n in sizes:
        if len(d) != n:
            return True
    for d, k, ref, ptr in links:
        v = d.get(k)
        if v is not (None if ref is None else ref()) or \
                (ptr and _address(v) != ptr):
            return True
    return False


# the decode loops read "every row finished" from the card this often
# (in steps); they run at most twice this many steps past the last eos
EOS_CHECK_EVERY = 8
# device bytes of buffers the programs of one model keep resident; past
# it the least recently used programs go (one bucket of 32 x 2048 at
# Llama-3-8B is ~8.6 GB of KV)
RESIDENT_BYTES = 8 << 30

_eager = threading.local()


@contextlib.contextmanager
def eager_steps():
    """Inside this block, on this thread, every :class:`CapturedStep`
    runs its function eagerly instead of replaying its graph (the
    uncaptured reference a graphed run is held to)."""
    prev = getattr(_eager, "on", False)
    _eager.on = True
    try:
        yield
    finally:
        _eager.on = prev


class CapturedStep:
    """One step program on ``device``, ``method(*args)``: eager on the
    CPU; on a card the first call runs it and captures it
    (:func:`capture`), later calls replay the graph. The capture goes to
    ``pool``, or to a pool of its own. Calls hold a share of
    ``card_lock``. ``method`` (bound) is held weakly: its owner holds the
    step, and a cycle through the step would leave the owner, and the
    graph, to the garbage collector."""

    nbytes = 0      # it owns no buffers (for ExecCache's budget)

    def __init__(self, method: Callable[..., None], device: torch.device,
                 pool=None, args: tuple = ()):
        self._method = weakref.WeakMethod(method)
        self.args, self.device, self.pool = args, device, pool
        self.graph = None
        self.pool_bytes = 0

    def fn(self):
        self._method()(*self.args)

    def stale(self) -> bool:
        return False

    def __call__(self):
        if self.device.type != "cuda":
            self.fn()
            return
        with card_lock.shared():
            if getattr(_eager, "on", False):
                self.fn()
            elif self.graph is None:
                self.graph, self.pool_bytes = capture(
                    self.fn, self.device,
                    self.pool or torch.cuda.graph_pool_handle())
            else:
                self.graph.graph.replay()
                add_launches(self.graph.launches)


class ExecCache(Mapping):
    """A model's captured programs keyed by shape and configuration, read
    as a mapping of key -> program. ``generate()``'s (fixed buffers and
    their :class:`CapturedStep`) hang off the model object
    (``model._gen_exec_cache``: model -> cache -> program -> model is a
    plain cycle the gc collects once the caller drops the model); a
    ``PagedEngine`` keeps its tick programs (a :class:`CapturedStep`
    each, in the cache's :meth:`shared_pool`) in one of its own.

    With ``budget_bytes``, the programs that stay resident are bounded:
    beyond it, counted in their buffers' bytes, the least recently used
    go (the newest always stays). Every program is dropped when the
    model's weights moved since they were built (:func:`weights_moved`).
    A program whose ``stale()`` says so (its draft model's weights moved,
    or the draft is gone) is dropped at the next :meth:`get`, and rebuilt
    when asked for."""

    def __init__(self, model, budget_bytes: Optional[int] = None):
        self._model = weakref.ref(model)
        self.budget_bytes = budget_bytes
        self.programs: "OrderedDict[tuple, Any]" = OrderedDict()
        self._links = None
        self._pool = None
        self._lock = threading.Lock()

    def __getitem__(self, key):
        return self.programs[key]

    def __iter__(self):
        return iter(list(self.programs))

    def __len__(self):
        return len(self.programs)

    def moved(self) -> bool:
        """True when the model's weights moved since the programs were
        built, or none were."""
        return self._links is None or weights_moved(self._links)

    def get(self, key: tuple, build: Callable[[], Any]):
        model = self._model()
        with self._lock:
            if self.moved():
                self._clear()
                self._links = weights_links(model)
            for k in [k for k, p in self.programs.items() if p.stale()]:
                del self.programs[k]
            prog = self.programs.pop(key, None)
            if prog is None:
                prog = build()
            self.programs[key] = prog
            while self.budget_bytes is not None and \
                    len(self.programs) > 1 and sum(
                        p.nbytes for p in self.programs.values()) \
                    > self.budget_bytes:
                self.programs.popitem(last=False)
        return prog

    def clear(self):
        """Forget every program (new weights or state): the next call of
        each builds and captures it again."""
        with self._lock:
            self._clear()

    def _clear(self):
        self.programs.clear()
        self._links = None
        self._pool = None

    def shared_pool(self):
        """One graph pool for programs that never run at once, new after
        every clear."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def graph_pool_bytes(self) -> int:
        """Device memory the programs' captures reserved, summed."""
        return sum(p.pool_bytes for p in self.programs.values())


class DecodeProgram:
    """What the decode programs share: the device, a lock that keeps one
    call at a time on the buffers, and the captured step (``_step``)."""

    nbytes = 0      # the buffers' bytes, for ExecCache's budget
    last_steps = 0  # steps the last call ran

    def __init__(self, device):
        self.device = device
        self.lock = threading.Lock()
        self.step = CapturedStep(self._step, device)

    def stale(self) -> bool:
        return False

    def run(self, *args):
        """One call (``_run``) on the program's buffers: one at a time,
        and on a card under a share of ``card_lock``."""
        with self.lock:
            if self.device.type != "cuda":
                return self._run(*args)
            with card_lock.shared():
                return self._run(*args)

    def _run(self, *args):
        raise NotImplementedError

    @property
    def pool_bytes(self) -> int:
        return self.step.pool_bytes

    def _step(self):
        raise NotImplementedError

    def run_steps(self, n: int, flag=None, every: int = EOS_CHECK_EVERY):
        """``n`` steps; with ``flag`` (a device bool "nothing left to
        do"), stop early once it reads True. On a card it is copied to a
        pinned buffer every ``every`` steps and read one check later, so
        the host never waits on the step it just launched. Returns, and
        keeps in ``last_steps``, the steps run."""
        host = pending = None
        if flag is not None and self.device.type == "cuda":
            host = torch.zeros((), dtype=torch.bool, pin_memory=True)
        ran = 0
        while ran < n:
            self.step()
            ran += 1
            if flag is None or ran % every:
                continue
            if host is None:
                if bool(flag):
                    break
                continue
            if pending is not None:
                pending.synchronize()
                if bool(host):
                    break
            host.copy_(flag, non_blocking=True)
            pending = torch.cuda.Event()
            pending.record()
        self.last_steps = ran
        return ran


def exec_cache_for(model, budget_bytes: int) -> ExecCache:
    cache = getattr(model, "_gen_exec_cache", None)
    if cache is None:
        cache = ExecCache(model, budget_bytes)
        object.__setattr__(model, "_gen_exec_cache", cache)
    return cache


def buffer_bytes(*tensors) -> int:
    """Bytes of the tensors (nested lists and tuples of them too)."""
    total = 0
    for t in tensors:
        if isinstance(t, (list, tuple)):
            total += buffer_bytes(*t)
        elif torch.is_tensor(t):
            total += t.numel() * t.element_size()
    return total
