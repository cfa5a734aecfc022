"""Logging setup.

The reference logs through DPDK ``RTE_LOG(level, USER1, ...)`` (e.g. the
qp->lcore map at init, ``device.cc:140-144``; pool summaries,
``memory.cc:151-155``).  Here: stdlib logging under the ``bitar_tpu_torch.*``
namespace, configured once, level via ``BITAR_TPU_LOG`` env var.
"""

from __future__ import annotations

import logging
import os

_CONFIGURED = False


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    level = os.environ.get("BITAR_TPU_LOG", "INFO").upper()
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s", "%H:%M:%S"))
    root = logging.getLogger("bitar_tpu_torch")
    root.addHandler(handler)
    root.setLevel(getattr(logging, level, logging.INFO))
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"bitar_tpu_torch.{name}")
