"""Device ms a read request spends in device-to-host memcpys (the engine's
burst readback)."""

from benchmark.trace.device import memcpy_s, per_step_ms


def read(readings):
    return per_step_ms(readings, lambda ev: memcpy_s(ev, "DtoH"))
