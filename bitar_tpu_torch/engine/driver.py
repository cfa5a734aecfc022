"""Driver: device discovery and stream placement.

Counterpart of ``bitar_tpu/engine/driver.py``: a per-process singleton that
lists the local devices and builds one engine per requested device.  The
devices are the CUDA devices ``torch.cuda.device_count()`` reports; with
``device_type="cpu"`` the one CPU device, on which any number of engines may
run (the plain PyTorch path).
"""

from __future__ import annotations

import threading

import torch

from ..config import EngineConfig, capabilities_for_device
from ..status import Status, StatusError
from ..utils.logging import get_logger
from .device import Engine

logger = get_logger("engine.driver")


class Driver:
    """Singleton device discovery + engine factory."""

    _instance: "Driver | None" = None
    _instance_lock = threading.Lock()

    @classmethod
    def instance(cls) -> "Driver":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = Driver()
            return cls._instance

    # -- discovery -----------------------------------------------------
    @staticmethod
    def list_available_devices(device_type: str = "cuda") -> list[torch.device]:
        """The local devices of ``device_type``: every CUDA device, or the
        one CPU device."""
        if device_type == "cpu":
            return [torch.device("cpu")]
        if device_type != "cuda":
            raise StatusError(Status.Invalid(f"device_type {device_type!r} not in (cuda, cpu)"))
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    def describe(self, device_type: str = "cuda") -> dict:
        devs = self.list_available_devices(device_type)
        return {
            "local_devices": [str(d) for d in devs],
            "device_count": len(devs),
            "device_class": capabilities_for_device(devs[0]).name if devs else None,
        }

    # -- engine construction -------------------------------------------
    def get_engines(self, config: EngineConfig, device_ids: list[int] | None = None,
                    device_type: str = "cuda") -> list[Engine]:
        """One initialized engine per entry of ``device_ids`` (default: one
        per device); an id may repeat."""
        devices = self.list_available_devices(device_type)
        if not devices:
            raise StatusError(Status.Invalid(f"no {device_type} devices visible"))
        if device_ids is None:
            device_ids = list(range(len(devices)))
        for d in device_ids:
            if not (0 <= d < len(devices)):
                raise StatusError(Status.Invalid(
                    f"device id {d} out of range [0, {len(devices)})"))
        engines = [Engine(config, device=devices[d]).initialize() for d in device_ids]
        logger.info("driver created %d engine(s) on %s",
                    len(engines), [str(devices[d]) for d in device_ids])
        return engines

    @staticmethod
    def place_streams(num_streams: int, engines: list[Engine]) -> list[Engine]:
        """Round-robin stream -> engine placement."""
        if not engines:
            raise StatusError(Status.Invalid("no engines to place streams on"))
        return [engines[i % len(engines)] for i in range(num_streams)]
