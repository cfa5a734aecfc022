"""Build a shared library at first use, safely across processes.

The port builds two libraries from sources in the checkout: the host codec
library (g++, from ``bitar_tpu/ops/cpu/*.cc``) and the CUDA decode kernel
(nvcc, from ``csrc/*.cu``).  Several processes may ask for the same library
at once (pytest workers, a server's replicas), so the build:

* names its output after a hash of the sources and the command, so a stale
  library is never loaded and no timestamp check is needed;
* runs under an exclusive ``fcntl`` lock on a file beside the output, and
  checks again for the output once it holds the lock;
* compiles into a temporary name and ``os.replace``s it into place, so no
  process ever loads a half-written library.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

from ..status import Status, StatusError

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


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
