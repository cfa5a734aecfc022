"""The port's headline measurement (``bitar_tpu_torch.cli.bench``) on the CPU,
against the root ``bench.py`` and the JAX package.

The reference's line is read from ``bench.py``'s source with ``ast``, so no
JAX bench runs.  At 4 blocks and ``BENCH_REPS=1`` the port's bench runs whole
under ``--device cpu`` (the kernels' plain versions), and its device-offload
sizes are held to ``bitar_tpu.ops.device_compress.compress_blocks_device`` in
interpret mode on the same planes and arguments.  Tolerance 0: sizes are
integers, and a ratio is the same formula over equal sizes.
"""

import ast
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitar_tpu.ops import device_compress as jdc
from bitar_tpu_torch.cli import bench
from bitar_tpu_torch.config import Codec
from bitar_tpu_torch.ops.device_compress import compress_blocks_device
from bitar_tpu_torch.status import StatusError
from bitar_tpu_torch.utils.corpus import BLOCK, make_corpus, make_text_corpus

ROOT = Path(__file__).resolve().parent.parent
NBLOCKS = 4


def reference_line() -> dict:
    """The dict literal of ``bench.py``'s last ``json.dumps``: {key: value
    node}."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    dumps = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr == "dumps"
             and n.args and isinstance(n.args[0], ast.Dict)]
    last = max(dumps, key=lambda n: n.lineno).args[0]
    return {k.value: v for k, v in zip(last.keys, last.values)}


def raw_fallback_ratio(sizes: np.ndarray, width: int) -> float:
    stored = sum(BLOCK if s >= BLOCK or s > width else int(s) for s in sizes)
    return len(sizes) * BLOCK / stored


def planes_of(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8).reshape(-1, BLOCK).copy()


def test_keys_equal_the_references():
    ref = reference_line()
    assert tuple(ref) == bench.KEYS
    assert len(bench.KEYS) == 23
    line = bench.bench_line(NBLOCKS * BLOCK, 0.001, 0.002,
                            {k: 1.0 for k in bench.KEYS[4:] if k not in
                             ("compress_GBps", "combined_GBps")})
    assert list(line) == list(ref)
    assert line["metric"] == ref["metric"].value
    assert line["unit"] == ref["unit"].value


def test_main_on_the_cpu_prints_the_line(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_NBLOCKS", str(NBLOCKS))
    monkeypatch.setenv("BENCH_REPS", "1")
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert tuple(line) == bench.KEYS
    # The background plan build ends during the commit upload here (and did
    # on the card at 1024 blocks), so the plan join rounds to 0.0 at the
    # reference's 0.1 ms: that one key may read 0.
    assert bench.MAY_READ_ZERO == ("plan_build_ms",)
    for key, v in line.items():
        if key in ("metric", "unit"):
            assert isinstance(v, str)
        else:
            assert isinstance(v, (int, float)) and math.isfinite(v), (key, v)
            assert v > 0 or (v == 0 and key in bench.MAY_READ_ZERO), (key, v)


def test_offload_ratios_equal_the_jax_packages():
    nums, sizes = bench.device_offload_phase(make_corpus(NBLOCKS), NBLOCKS, 1, "cpu")
    planes = planes_of(make_corpus(NBLOCKS))
    lens = np.full(NBLOCKS, BLOCK, np.int32)
    _, jsz = jdc.compress_blocks_device(jnp.asarray(planes), jnp.asarray(lens),
                                        interpret=True, **bench.OFFLOAD_LZ4)
    jsz = np.asarray(jsz)
    np.testing.assert_array_equal(sizes["lz4"], jsz)
    assert nums["device_offload_ratio"] == raw_fallback_ratio(
        jsz, bench.OFFLOAD_LZ4["out_width"])
    tplanes = planes_of(make_text_corpus(NBLOCKS))
    _, jtsz = jdc.compress_blocks_device(jnp.asarray(tplanes), jnp.asarray(lens),
                                         interpret=True, **bench.OFFLOAD_TEXT)
    jtsz = np.asarray(jtsz)
    assert len(sizes["text"]) == 1
    np.testing.assert_array_equal(sizes["text"][0], jtsz)
    assert nums["device_offload_text_ratio"] == raw_fallback_ratio(
        jtsz, bench.OFFLOAD_TEXT["out_width"])


def test_text_offload_sizes_each_chunk_by_its_rows():
    # 4 blocks in chunks of 3: the last chunk has 1 row, and its lengths
    # too (the reference's bench.py:502 gives every chunk 64).  Each chunk's
    # sizes equal the JAX package's on that chunk alone: detect_fft="sample"
    # takes its offsets from the chunk's own rows.
    tplanes = planes_of(make_text_corpus(NBLOCKS))
    chunks = bench.text_chunks(torch.from_numpy(tplanes), 3)
    assert [(p.shape[0], ln.shape[0]) for p, ln in chunks] == [(3, 3), (1, 1)]
    _, res = bench.offload_text(chunks)
    for (p, ln), (out, sizes) in zip(chunks, res):
        assert bench.check_offload_rows(Codec.LZ4, out, sizes, p, ln, "text") == p.shape[0]
        _, jsz = jdc.compress_blocks_device(jnp.asarray(p.numpy()), jnp.asarray(ln.numpy()),
                                            interpret=True, **bench.OFFLOAD_TEXT)
        np.testing.assert_array_equal(sizes, np.asarray(jsz))


def test_check_offload_rows_refuses_a_wrong_row():
    # Blocks 0 and 3 of the corpus (text and RLE) compress; 1 and 2 store RAW.
    planes = torch.from_numpy(planes_of(make_corpus(4))[[0, 3]])
    lens = torch.full((2,), BLOCK, dtype=torch.int32)
    out, sizes = compress_blocks_device(planes, lens, **bench.OFFLOAD_LZ4)
    sizes = sizes.numpy()
    assert bench.check_offload_rows(Codec.LZ4, out, sizes, planes, lens, "ok") == 2
    bad = planes.clone()
    bad[1, 5] ^= 1
    with pytest.raises(StatusError, match="does not decode to its block"):
        bench.check_offload_rows(Codec.LZ4, out, sizes, bad, lens, "bad")


def test_check_offload_rows_decodes_short_blocks_to_their_length():
    # Blocks shorter than the plane (zero past their length), as the
    # emitter's checks give them: each row decodes to its own length, and a
    # row whose size reaches its length is left to the RAW fallback.
    lens = torch.tensor([1000, 50000, 64], dtype=torch.int32)
    planes = torch.zeros((3, BLOCK), dtype=torch.uint8)
    for b, ln in enumerate(lens.tolist()):
        planes[b, :ln] = torch.arange(ln, dtype=torch.int32) // 97 % 7
    planes[2, :64] = torch.from_numpy(np.random.default_rng(3).integers(0, 256, 64, np.uint8))
    out, sizes = compress_blocks_device(planes, lens, seg=1024, min_match=6, out_width=65536)
    assert int(sizes[2]) >= 64 and int(sizes[0]) < 1000
    assert bench.check_offload_rows(Codec.LZ4, out, sizes, planes, lens, "short") == 2
    bad = planes.clone()
    bad[1, 49999] ^= 1
    with pytest.raises(StatusError, match="does not decode to its block"):
        bench.check_offload_rows(Codec.LZ4, out, sizes, bad, lens, "short")


def test_cuda_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as ei:
        bench.main(["--device", "cuda"])
    assert ei.value.code == 1
    err = capsys.readouterr()
    assert "torch.cuda.is_available() is false" in err.err
    assert err.out == ""
