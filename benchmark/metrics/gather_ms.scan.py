"""Device ms a scan spends in the arena gather's copy kernels (``index_select``
of whole slots in ``DeviceArena.gather_burst``)."""

from benchmark.trace.device import GATHER, kernel_s, per_step_ms


def read(readings):
    return per_step_ms(readings, lambda ev: kernel_s(ev, GATHER))
