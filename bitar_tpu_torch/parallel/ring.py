"""Ring-pipelined shuffle + decode: per-peer rounds, decode overlapping the
exchange.

Counterpart of ``bitar_tpu/parallel/ring.py``.  ``distributed_step_flat``
issues one all-to-all and then decodes everything it received; this variant
makes the reference's hot-loop trick — enqueue the next burst while the
device works on the previous one (``device.cc:197-226``) — explicit:

* every round's send and receive is posted up front (one
  ``dist.batch_isend_irecv`` per round), as the JAX step issues all its
  ``ppermute``s:
  in round r (1..D-1) rank i sends its chunk for peer (i + r) mod D and
  receives from (i - r) mod D;
* round 0 decodes the kept chunk (no communication) while the exchange is
  in flight, and each received chunk decodes as soon as its round has
  arrived, while later rounds are still moving.

Wire layout and output order match ``distributed_step_flat`` (same staging
metadata, per-(dst, src)-chunk flat wires from
``prepare_ring_flat_wires_for_recv``), so the two are interchangeable; both
run kernel B1.  On a gloo group, CUDA chunks travel through pinned host
buffers (gloo's point-to-point ops take only CPU tensors).

On an NCCL group nothing waits on the host: NCCL moves the rounds on its
own stream, and ``Work.wait()`` makes the current stream wait for a round,
so each decode is queued behind its round on the device.  Whether the
decodes overlap the exchange shows on the device's clock: given
``events``, the step records CUDA events (:func:`ring_timeline` reads
them).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.decode_flat import LANES, decode_blocks_flat
from .pipeline import WIRE_KEYS
from .sharding import mesh_group, mesh_rank
from .shuffle import stage_rows


def distributed_step_ring_flat(slot_rows, send_idx, valid, p_used, p_off, p0, dense, dq_idx,
                               se, shift, dq, row_a, *, mesh: DeviceMesh, rows_per_pair: int,
                               comp_rows: int, block_size: int,
                               events: dict | None = None) -> torch.Tensor:
    """Ring-pipelined shuffle + FLAT-PLAN decode (kernel B1 per chunk).

    Arguments as ``distributed_step_flat``'s, except the wires: this rank's
    slice of :func:`prepare_ring_flat_wires_for_recv`'s arrays, each with a
    leading [D_src] chunk axis.  Returns this rank's [D * rpp, block_size]
    uint8 rows in ``distributed_step_flat``'s order.

    ``events`` (NCCL only; ignored elsewhere): a dict the step fills with
    CUDA events: "post" on the current stream before the rounds are posted,
    "arrived" one a round on a stream that waits for nothing else, and
    "decoded" a (start, end) pair a round's decode on the current stream;
    and "posting_ms", the host's milliseconds to post every round."""
    d, me, rpp = mesh.size(), mesh_rank(mesh), rows_per_pair
    group = mesh_group(mesh)
    staged = stage_rows(slot_rows, send_idx, valid).view(d, rpp, -1)
    wires = dict(zip(WIRE_KEYS, (p_used, p_off, p0, dense, dq_idx, se, shift, dq, row_a),
                     strict=True))
    out = torch.empty((d, rpp, block_size), dtype=torch.uint8, device=staged.device)

    # gloo's point-to-point ops take only CPU tensors (its all-to-all takes
    # CUDA tensors as they are): stage CUDA chunks through pinned host memory.
    staging = staged.is_cuda and dist.get_backend(group) == "gloo"
    timed = events is not None and staged.is_cuda and not staging
    bufs, works = {}, {}
    if timed:
        events.update(post=_event(), arrived=[], decoded=[])
        t0 = time.perf_counter()
    for r in range(1, d):                          # every round posted up front
        send = staged[(me + r) % d]
        recv = torch.empty_like(send)
        if staging:
            send = send.to("cpu").pin_memory()
            recv = torch.empty(recv.shape, dtype=recv.dtype, pin_memory=True)
        bufs[r] = recv
        works[r] = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dist.get_global_rank(group, (me + r) % d), group),
            dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (me - r) % d), group)])

    if timed:
        events["posting_ms"] = 1e3 * (time.perf_counter() - t0)
        arrivals = torch.cuda.Stream(staged.device)
        with torch.cuda.stream(arrivals):
            for r in range(1, d):
                for w in works[r]:
                    w.wait()
                events["arrived"].append(_event(arrivals))

    def decode(rows: torch.Tensor, src: int) -> None:
        start = _event() if timed else None
        chunk = {k: v[src] for k, v in wires.items()}
        out[src] = decode_blocks_flat(rows, chunk, comp_rows=comp_rows,
                                      out_rows=block_size // LANES).view(rpp, block_size)
        if timed:
            events["decoded"].append((start, _event()))

    decode(staged[me], me)                         # round 0: the kept chunk
    for r in range(1, d):                          # round r, once it has arrived
        for w in works[r]:
            w.wait()
        rows = bufs[r].to(staged.device, non_blocking=True) if staging else bufs[r]
        decode(rows, (me - r) % d)
    return out.view(d * rpp, block_size)


def _event(stream=None) -> torch.cuda.Event:
    e = torch.cuda.Event(enable_timing=True)
    e.record(stream)
    return e


def ring_timeline(events: dict) -> dict:
    """Milliseconds after "post" of a synchronized ring step's ``events``:
    the last round's arrival (``exchange_ms``), each decode's span, their
    sum (``decode_ms``) and the part of it inside the exchange
    (``overlap_ms``), the last decode's end (``step_ms``), and the host's
    time to post the rounds (``posting_ms``).  An event marks when the
    device reached it, and no earlier than the host queued it: an arrival
    or a decode start reads no earlier than the end of the posting."""
    post = events["post"]
    arrived = [post.elapsed_time(e) for e in events["arrived"]]
    spans = [(post.elapsed_time(a), post.elapsed_time(b)) for a, b in events["decoded"]]
    return timeline_summary(max(arrived, default=0.0), spans) | {
        "posting_ms": events["posting_ms"]}


def timeline_summary(exchange_end: float, spans: list[tuple[float, float]]) -> dict:
    """The numbers of :func:`ring_timeline` from the exchange's end and the
    decode spans, all in ms after the rounds were posted."""
    return {"exchange_ms": exchange_end,
            "decode_spans_ms": [list(s) for s in spans],
            "decode_ms": sum(b - a for a, b in spans),
            "overlap_ms": sum(max(0.0, min(b, exchange_end) - a) for a, b in spans),
            "step_ms": max((b for _, b in spans), default=0.0)}
