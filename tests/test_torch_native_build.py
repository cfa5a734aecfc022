"""The host codec library, built once per checkout before any test runs.

Both packages compile the same C++ (``bitar_tpu/ops/cpu/*.cc``).  The port
builds its copy under a file lock (``bitar_tpu_torch/ops/_build.py``); the
JAX package runs cmake and ninja in its shared ``build/`` directory at first
use, guarded only by a thread lock.  Under ``pytest -n 6`` several worker
processes could reach that build together and leave a broken cmake cache
behind, which fails every later test that needs the library, the port's
parity tests among them.  This module builds the JAX package's library
while it is collected, under a file lock in that build directory: every
worker collects every module before it runs a test, so each finds the
library built.  A failed build is left for the tests that need the library
to report.
"""

import fcntl

import numpy as np
import pytest

from bitar_tpu.ops.cpu import native as jnative
from bitar_tpu_torch.ops.cpu import native as tnative


def _build_reference_library() -> None:
    jnative._BUILD_DIR.mkdir(exist_ok=True)
    with open(jnative._BUILD_DIR / "collect.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            jnative.load()
        except Exception:      # reported by the tests that load it
            pass


_build_reference_library()


@pytest.mark.parametrize("min_match", [4, 6])
def test_both_builds_code_the_same_bytes(min_match):
    rng = np.random.default_rng(5)
    data = np.repeat(rng.integers(0, 256, 4096, np.uint8), rng.integers(1, 9, 4096)).tobytes()
    got = tnative.lz4_compress(data, min_match=min_match)
    want = jnative.lz4_compress(data, min_match=min_match)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jnative.lz4_decompress(got, len(data)),
                                  np.frombuffer(data, np.uint8))
