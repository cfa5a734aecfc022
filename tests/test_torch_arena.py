"""The cases of ``tests/test_arena.py`` against the port's arena and host
pool, plus byte parity with the JAX arena for the same writes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitar_tpu.memory.arena import DeviceArena as JaxArena
from bitar_tpu_torch.memory.arena import DeviceArena, SlotPool
from bitar_tpu_torch.memory.host_pool import (
    POISON_BYTE,
    HostMemoryPool,
    PoolBackend,
    get_memory_pool,
)
from bitar_tpu_torch.status import StatusError

# Test files run in several worker processes at once: a single intra-op
# thread keeps torch's CPU pool from oversubscribing the cores (the
# tensors here are small).
torch.set_num_threads(1)


def test_slot_pool_take_put():
    p = SlotPool(preallocated=20, max_slots=40, slot_size=128)
    got = p.take(5)
    assert len(got) == 5 and len(set(got)) == 5
    assert p.in_use() == 5
    p.put(got)
    assert p.in_use() == 0
    assert p.stats.num_takes == 5 and p.stats.num_puts == 5


def test_slot_pool_min_preallocate():
    with pytest.raises(StatusError):
        SlotPool(preallocated=3, max_slots=40, slot_size=128)


def test_slot_pool_critical_growth_and_exhaustion():
    p = SlotPool(preallocated=20, max_slots=25, slot_size=128)
    got = p.take(24)  # grows past preallocation
    assert p.stats.critical_growths >= 1
    assert p.capacity == 24
    with pytest.raises(StatusError):  # beyond max_slots
        p.take(2)
    assert p.in_use() == 24           # failed take must not leak slots
    p.put(got)


def test_slot_pool_double_put_rejected():
    p = SlotPool(preallocated=20, max_slots=40, slot_size=128)
    (s,) = p.take(1)
    p.put(s)
    with pytest.raises(StatusError):
        p.put(s)


def test_device_arena_write_gather_roundtrip():
    rng = np.random.default_rng(21)
    arena = DeviceArena(slot_size=256, preallocated=20, max_slots=32, device="cpu")
    rows = rng.integers(0, 256, (4, 256), dtype=np.uint8)
    slots = arena.pool.take(4)
    arena.write_burst(slots, torch.from_numpy(rows))
    np.testing.assert_array_equal(arena.gather_burst(slots).numpy(), rows)
    np.testing.assert_array_equal(arena.gather_burst(slots[::-1]).numpy(), rows[::-1])
    arena.pool.put(slots)


def test_device_arena_defaults_to_the_card(monkeypatch):
    # Like Engine: no device means CUDA, and without CUDA that is an error,
    # not a quiet CPU arena.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(StatusError, match="device='cpu'"):
        DeviceArena(slot_size=128, preallocated=20, max_slots=32)
    assert DeviceArena(slot_size=128, preallocated=20, max_slots=32,
                       device="cpu").device.type == "cpu"


def test_device_arena_refs_and_recycle():
    arena = DeviceArena(slot_size=128, preallocated=20, max_slots=32, device="cpu")
    refs = arena.take_refs([100, 50, 128])
    assert arena.pool.in_use() == 3
    assert arena.recycle(refs) == 3
    assert arena.pool.in_use() == 0
    with pytest.raises(StatusError):  # unknown ref
        arena.recycle(refs)


def test_device_arena_read_host_respects_length():
    rng = np.random.default_rng(22)
    arena = DeviceArena(slot_size=128, preallocated=20, max_slots=32, device="cpu")
    data = rng.integers(0, 256, (1, 128), dtype=np.uint8)
    (ref,) = arena.take_refs([77])
    arena.write_burst([ref.slot], data)
    out = arena.read_host(ref)
    assert out.shape == (77,)
    np.testing.assert_array_equal(out, data[0, :77])


def test_prefix_write_zero_fills_tail_like_jax_arena():
    # A used-prefix write zeroes the slot's tail, over a dirty slot: the
    # port and the JAX arena hold the same bytes after the same writes.
    rng = np.random.default_rng(23)
    port = DeviceArena(slot_size=512, preallocated=20, max_slots=24, device="cpu")
    ref = JaxArena(slot_size=512, preallocated=20, max_slots=24)
    full = rng.integers(0, 256, (3, 512), dtype=np.uint8)
    prefix = rng.integers(0, 256, (2, 128), dtype=np.uint8)
    for arena, conv in ((port, torch.from_numpy), (ref, jnp.asarray)):
        arena.write_burst([5, 9, 2], conv(full))
        arena.write_burst([9, 5], conv(prefix))
    got = port.gather_burst([5, 9, 2]).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.gather_burst([5, 9, 2])))
    assert not got[:2, 128:].any()


@pytest.mark.parametrize("rows, slots", [
    (np.zeros((2, 600), np.uint8), [0, 1]),     # wider than a slot
    (np.zeros((2, 64), np.int32), [0, 1]),      # not bytes
    (np.zeros((3, 64), np.uint8), [0, 1]),      # row/slot count mismatch
])
def test_write_burst_rejects_bad_rows(rows, slots):
    arena = DeviceArena(slot_size=512, preallocated=20, max_slots=24, device="cpu")
    with pytest.raises(StatusError):
        arena.write_burst(slots, rows)


def test_host_pool_reuse_and_stats():
    pool = HostMemoryPool(PoolBackend.POOLED)
    b1 = pool.allocate(5000)
    assert b1.view().shape == (5000,)
    b1.free()
    b2 = pool.allocate(6000)  # same 8 KiB bucket -> reused
    assert pool.stats.num_reuses == 1
    b2.free()


def test_host_pool_poisoning():
    pool = HostMemoryPool(PoolBackend.POOLED, debug_poison=True)
    b = pool.allocate(100)
    assert (b.view() == POISON_BYTE).all()
    b.view()[:] = 1
    b.free()


def test_host_pool_aligned_backend():
    pool = HostMemoryPool(PoolBackend.ALIGNED)
    b = pool.allocate(10000)
    assert b.array.ctypes.data % 4096 == 0
    b.free()


def test_get_memory_pool_singleton():
    assert get_memory_pool(PoolBackend.POOLED) is get_memory_pool(PoolBackend.POOLED)
    assert get_memory_pool(PoolBackend.SYSTEM) is not get_memory_pool(PoolBackend.POOLED)


def test_double_free_is_noop():
    pool = HostMemoryPool(PoolBackend.POOLED)
    b = pool.allocate(100)
    b.free()
    b.free()
