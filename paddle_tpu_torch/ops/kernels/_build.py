"""Build and load the CUDA kernels.

Each source in ``paddle_tpu_torch/csrc/*.cu`` is compiled by its own
``nvcc`` process, all started together, into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

The libraries go into ``paddle_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and an unchanged one is reused. They are loaded with
``ctypes``. Every C entry point returns a ``cudaError_t``; the Python
wrapper raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Tuple

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], Any] = {}


@dataclass
class Built:
    name: str
    path: Path
    seconds: float      # 0.0 when an earlier build was reused
    ptxas: str          # nvcc's -Xptxas -v report ("" when reused)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def build_all() -> Dict[str, Built]:
    """Compile every kernel source not yet built, all in parallel; return
    one ``Built`` per source. Raises with nvcc's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no kernel sources in {CSRC}")
    built: Dict[str, Built] = {}
    running = []
    compiler = None
    for src in sources:
        target = _target(src)
        if target.exists():
            built[src.stem] = Built(src.stem, target, 0.0, "")
            continue
        compiler = compiler or nvcc()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, target, tmp, proc, time.perf_counter()))
    failures = []
    for src, target, tmp, proc, t0 in running:
        try:
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failures.append(f"{src.name}: nvcc timed out\n{out}")
            continue
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{src.name}: nvcc exited {proc.returncode}\n"
                            f"{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)
        built[src.stem] = Built(src.stem, target, seconds, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return built


def entry(name: str, symbol: str, argtypes):
    """C function ``symbol`` of ``csrc/<name>.cu`` with its argument types
    declared (``c_void_p`` for every pointer and the stream, or ctypes
    would pass them as 32-bit ints) and a ``cudaError_t`` result; looked
    up and declared at the first call, then reused (a wrapper calls this
    at every launch)."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


def check(name: str, rc: int) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if rc == 0:
        return
    explain = load(name).kernel_error_string
    explain.argtypes = [ctypes.c_int]
    explain.restype = ctypes.c_char_p
    raise RuntimeError(f"{name} kernel failed: CUDA error {rc} "
                       f"({explain(rc).decode()})")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            built = build_all()
            if name not in built:
                raise KeyError(f"no kernel source csrc/{name}.cu")
            lib = ctypes.CDLL(str(built[name].path))
            _loaded[name] = lib
        return lib
