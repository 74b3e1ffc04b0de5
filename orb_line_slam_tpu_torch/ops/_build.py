"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each source ``csrc/<name>.cu`` exports one C function ``<name>_launch``
whose last argument is the stream and which returns ``cudaGetLastError()``.
It is compiled with nvcc for sm_90a into ``csrc/build/lib<name>.so`` at
first use (rebuilt when the source is newer), loaded with ctypes, and its
function pointer and ``argtypes`` are resolved once.  A failed build
raises with the compiler's output; nothing falls back.  ``builds`` records
each build and load of the process: which kernel, whether nvcc ran, and
the seconds it took.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..utils.timing import span

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("patch_tiles", "orb_describe", "stereo_sad", "pose_solve")
_FUNCTIONS: dict[str, ctypes._CFuncPtr] = {}
# {"kernel", "step": "nvcc" (built), "cached" (library up to date) or
# "load" (the library opened), "s"} of each build and load, in order.
builds: list[dict] = []


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def _paths(name: str) -> tuple[Path, Path]:
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _start_build(name: str, extra_flags=()):
    """Start nvcc on csrc/<name>.cu unless its library is up to date.
    Returns (process or None, temporary output, library path)."""
    src, so = _paths(name)
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return None, None, so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        *extra_flags, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src),
    ]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp, so


def _finish_build(name: str, proc, tmp: Path, so: Path) -> str:
    """Wait for a build started by ``_start_build``; returns nvcc's output."""
    if proc is None:
        return ""
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n{err}")
    os.replace(tmp, so)
    return out + err


def build(names=SOURCES, extra_flags=()) -> dict[str, tuple[float, str]]:
    """Build the named sources, one nvcc each, all started together.
    Returns per source the seconds from the common start until its build
    had finished, and nvcc's output (empty where nothing was rebuilt)."""
    t0 = time.perf_counter()
    started = [(name, *_start_build(name, extra_flags)) for name in names]
    done = {}
    try:
        for name, proc, tmp, so in started:
            output = _finish_build(name, proc, tmp, so)
            done[name] = (time.perf_counter() - t0, output)
            builds.append({"kernel": name, "step": "cached" if proc is None else "nvcc", "s": done[name][0]})
    finally:
        for _, proc, _, _ in started:       # a failed build leaves no compiler running
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.communicate()
    return done


def library_path(name: str) -> Path:
    return _paths(name)[1]


def kernel(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``<name>_launch`` of csrc/<name>.cu (built and loaded
    on the first call, then cached); ``argtypes`` excludes the stream."""
    fn = _FUNCTIONS.get(name)
    if fn is None:
        with span("kernel_load"):
            build((name,))
            t0 = time.perf_counter()
            fn = getattr(ctypes.CDLL(str(library_path(name))), f"{name}_launch")
            fn.argtypes = [*argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _FUNCTIONS[name] = fn
            builds.append({"kernel": name, "step": "load", "s": time.perf_counter() - t0})
    return fn


# The current stream's handle as a Python int, without building a Stream
# object (torch's own kernel launchers read it the same way).
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _current_stream(index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(fn, name: str, device: torch.device, *args) -> None:
    """Call a kernel's C function on ``device``'s current stream (no
    synchronisation); raises when the launch is refused.  The device
    context is entered only when ``device`` is not the current one."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, _current_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _current_stream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
