"""Build a shared library at first use, safely across processes.

The port builds two kinds of library from sources in the checkout: the host
codec library (g++, from ``bitar_tpu/ops/cpu/*.cc``) and one library per
CUDA kernel source (nvcc, from ``csrc/*.cu``).  Several processes may ask
for the same library at once (pytest workers, a server's replicas), so the
build:

* names its output after a hash of the sources and the command, so a stale
  library is never loaded and no timestamp check is needed;
* runs under an exclusive ``fcntl`` lock on a file beside the output, and
  checks again for the output once it holds the lock;
* compiles into a temporary name and ``os.replace``s it into place, so no
  process ever loads a half-written library.

The kernels' Python wrappers share the rest of their plumbing here: loading
a kernel library once per process, checking their inputs and the CUDA error
code a launch returns, and the block queue of the persistent kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..status import Status, StatusError

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CSRC = Path(__file__).resolve().parent.parent / "csrc"

_kernels: dict[str, ctypes.CDLL] = {}
_kernels_lock = threading.Lock()


def build_library(stem: str, sources: list[Path], command) -> Path:
    """Return the path of ``lib<stem>-<hash>.so``, building it if absent.

    ``command(out_path)`` returns the compiler argv that writes the library
    to ``out_path``.  The compiler's output is kept as ``<library>.log``.
    Raises StatusError with that output when the build fails."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(command(Path("OUT"))).encode())
    out = BUILD_DIR / f"lib{stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():                 # another process built it meanwhile
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run(command(tmp), capture_output=True, text=True)
            if proc.returncode != 0:
                raise StatusError(Status.IOError(
                    f"building {out.name} failed ({proc.returncode}):\n"
                    f"{proc.stderr[-4000:]}"))
            out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise StatusError(Status.IOError(
        "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA kernels "
        "cannot be built"))


def build_cuda_library(stem: str, source: Path, headers: tuple[Path, ...] = ()) -> Path:
    """Build ``source`` (a ``.cu`` with a plain C interface) for sm_90a into
    a shared library; ``headers`` it includes join the source hash.  The
    compiler's report (``-Xptxas -v``: registers, spills, shared memory) is
    kept beside the library as ``<library>.log``."""
    compiler = nvcc()
    return build_library(stem, [source, *headers], lambda out: [
        compiler, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(source)])


def load_cuda_kernel(stem: str, bind, headers: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build ``csrc/<stem>.cu`` at first use (``headers``: the ``csrc/``
    files it includes besides ``cuda_util.cuh``) and load it once per
    process; ``bind(lib)`` declares the library's launch function before any
    caller sees it.  Kernels of other stems build at the same time (the
    build itself is locked per stem)."""
    lib = _kernels.get(stem)
    if lib is None:
        path = build_cuda_library(stem, CSRC / f"{stem}.cu",
                                  tuple(CSRC / h for h in ("cuda_util.cuh", *headers)))
        with _kernels_lock:
            lib = _kernels.get(stem)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                lib.bt_error.restype = ctypes.c_char_p
                lib.bt_error.argtypes = [ctypes.c_int]
                bind(lib)
                _kernels[stem] = lib
    return lib


#: The block queue of the persistent kernels (B1, B7) per (device, stream):
#: int32 [next block, CTAs done], zero at launch.  A launch's last CTA sets
#: both back to zero, so one buffer serves every launch of a stream (they
#: run in turn) and no launch pays a memset of its own.
block_queues: dict[tuple[int, int], torch.Tensor] = {}


def block_queue(device: torch.device, stream: int) -> torch.Tensor:
    q = block_queues.get((device.index, stream))
    if q is None:                 # zeroed on this stream, before any launch on it
        q = block_queues.setdefault((device.index, stream),
                                    torch.zeros(2, dtype=torch.int32, device=device))
    return q


_sm_counts: dict[int, int] = {}     # streaming multiprocessors per device index


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device: the CTAs of a
    device-memory-route launch of B1 or B7, one per SM (a 1024-thread CTA of
    either kernel takes a whole SM's registers), each with a scratch plane."""
    sms = _sm_counts.get(device.index)
    if sms is None:
        sms = _sm_counts.setdefault(
            device.index, torch.cuda.get_device_properties(device).multi_processor_count)
    return sms


def require(cond: bool, msg) -> None:
    """Raise StatusError(Invalid(msg)) unless ``cond``: a wrapper's check of
    what its kernel takes.  ``msg`` is the message, or a function that
    builds it, called only on failure (so a passing check formats
    nothing)."""
    if not cond:
        raise StatusError(Status.Invalid(msg() if callable(msg) else msg))


def check_cuda(rc: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise StatusError(IOError) when kernel library ``lib`` returned CUDA
    error ``rc``."""
    if rc != 0:
        raise StatusError(Status.IOError(
            f"{what} failed: CUDA error {rc} ({lib.bt_error(rc).decode()})"))
