"""Blocks of 256 KiB to 1 MiB (planes of 2048 to 8192 rows) in the port,
against the JAX package, on the CPU.

The port's plain versions of B1 and B2 are what its kernels are held to on
the card; here they are held to the JAX package's: ``decode_flat_reference``
to the numpy oracle ``decode_flat_numpy`` on the engine's own wire (banded
above 1024 rows, and equal to the JAX engine's), ``decode_tables_reference``
to the JAX B2 kernel in interpret mode, and both engines to each other at
256 KiB and 1 MiB (uniform and skewed units, LZ4, Snappy and Zstd).  The
kernels' launch geometry (``cluster_ctas``: one CTA, or a cluster's CTAs, a
block) is checked for every plane height of 128 to 8192 rows.  Inputs come
from numpy seeds and the bench corpora; tolerance 0 (bytes, sizes, status).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitar_tpu as bt
from bitar_tpu.ops.pallas import layout as jlayout
from bitar_tpu.ops.pallas import lz4_decode_flat as jflat
from bitar_tpu.ops.pallas.lz4_decode import decode_blocks as jax_decode_blocks
import bitar_tpu_torch as btt
from bitar_tpu_torch import config as tconfig
from bitar_tpu_torch.interop import SCRATCH_PLAN_KEYS, TPU_ONLY_PLAN_KEYS
from bitar_tpu_torch.ops import decode_flat as df
from bitar_tpu_torch.ops import decode_tables as dt
from bitar_tpu_torch.ops.cpu.native import SEQUENCE_KEYS
from bitar_tpu_torch.utils.corpus import make_corpus, make_text_corpus

torch.set_num_threads(1)

KIB = 1024
CORPORA = {"bench": make_corpus, "text": make_text_corpus}
CODECS = {"lz4": (bt.Codec.LZ4, btt.Codec.LZ4), "snappy": (bt.Codec.SNAPPY, btt.Codec.SNAPPY),
          "zstd": (bt.Codec.ZSTD, btt.Codec.ZSTD)}


def port_engine(block: int, codec=btt.Codec.LZ4, **kw):
    cfg = btt.EngineConfig(codec=codec, block_size=block, burst_size=4, max_pool_slots=32,
                           commit="deferred", plan_build="lazy", **kw)
    return btt.Engine(cfg, device="cpu").initialize()


def jax_engine(block: int, codec=bt.Codec.LZ4, **kw):
    cfg = bt.EngineConfig(codec=codec, block_size=block, burst_size=4, max_pool_slots=32,
                          commit="deferred", plan_build="lazy", **kw)
    return bt.Engine(cfg).initialize()


@pytest.mark.parametrize("block", [256 * KIB, 1024 * KIB])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_flat_reference_equals_jax_oracle_on_the_banded_wire(corpus, block):
    # Two megabytes of the corpus through the port's engine: its plan wire
    # equals the JAX engine's (banded above 1024 rows), and the plain B1
    # decodes it to what the JAX oracle decodes, which is the raw bytes.
    data = CORPORA[corpus](16)
    nrows = block // 128
    port, ref = port_engine(block), jax_engine(block, use_tpu_kernels=True, interpret=True)
    tu, ju = port.compress(data), ref.compress(data)
    port.ensure_plans(tu)
    ref.ensure_plans(ju)
    pf = tu.plan_flat
    assert pf is not None and pf["host_blocks"].size == 0
    assert tu.plan_comp_rows == ju.plan_comp_rows
    for k, v in ju.plan_flat.items():
        if k not in TPU_ONLY_PLAN_KEYS + SCRATCH_PLAN_KEYS:
            np.testing.assert_array_equal(pf[k], v, err_msg=k)
    if corpus == "text":
        assert (pf["p_used"] > pf["p0"]).all(), "expected out passes in every block"
    assert (pf["dense"] > 0).all(), "expected dense passes"
    rows = port.arena.gather_burst([r.slot for r in tu.refs])
    got = df.decode_flat_reference(rows, tu.plan_device_arrays(), tu.plan_comp_rows, nrows)
    comps = [rows[i, :int(n)].numpy() for i, n in enumerate(tu.manifest.comp_len)]
    want = jflat.decode_flat_numpy(comps, pf, tu.plan_comp_rows, nrows)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().tobytes() == data
    port.release()
    ref.release()


@pytest.mark.parametrize("out_rows", [2048, 8192])
def test_flat_reference_equals_jax_oracle_on_random_wires(out_rows):
    # Every pass id, anchors around and far outside the comp plane, RAW
    # blocks, comp then out passes with random ranges and shifts.
    comp, plans = df.random_wire(70 + out_rows // 1024, 4, out_rows, 2 * out_rows, 16)
    pt = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in plans.items()}
    got = df.decode_flat_reference(torch.from_numpy(comp), pt, 2 * out_rows, out_rows)
    want = jflat.decode_flat_numpy(list(comp[:, :2 * out_rows * 128]), plans, 2 * out_rows,
                                   out_rows)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("out_rows", [1152, 8192])
def test_flat_reference_equals_jax_oracle_on_slice_crossing_wires(out_rows):
    # Out passes that gather across the kernel's 1024-row slices, whole and
    # part rows, and clip at both plane ends (the wire the card tests hold
    # the cluster route to).
    comp, plans = df.slice_crossing_wire(out_rows, 64 + out_rows // 128)
    pt = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in plans.items()}
    got = df.decode_blocks_flat(torch.from_numpy(comp), df.plan_tensors(plans, "cpu"),
                                comp_rows=out_rows, out_rows=out_rows)
    want = jflat.decode_flat_numpy(list(comp), plans, out_rows, out_rows)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy().reshape(4, -1) != comp).any()
    assert pt["p0"].tolist() == [1] * 4


def test_tables_reference_equals_jax_b2_at_1mib():
    # The JAX B2 in interpret mode takes ~10 s here at 1 MiB even for blocks
    # of one or two sequences (its trace and compile), so this holds it to
    # the plain version on such blocks only: a phrase, a run, random bytes
    # (stored RAW: one literal run).
    block = 1 << 20
    rng = np.random.default_rng(71)
    datas = [((b"large block phrase %d " % 1) * (block // 20 + 1))[:block], b"\x41" * block,
             rng.integers(0, 256, block, dtype=np.uint8).tobytes()]
    rows, tables, nseq, _ = dt.parser_tables(datas)
    n, w = rows.shape
    cr = w // 128
    planes = np.zeros((n, cr + jlayout.GUARD_ROWS, 128), np.int32)
    planes[:, :cr] = rows.reshape(n, cr, 128)
    S = tables["lit_ptr"].shape[1]
    want = jax_decode_blocks(
        jnp.asarray(planes), jnp.asarray(nseq), *(jnp.asarray(tables[k]) for k in SEQUENCE_KEYS),
        comp_rows=cr + jlayout.GUARD_ROWS, out_rows=block // 128 + jlayout.GUARD_ROWS,
        seq_cap=S, interpret=True)
    want = np.asarray(want)[:, :block // 128].astype(np.uint8).reshape(n, block)
    tn, tt = dt.table_tensors(tables, nseq, "cpu")
    got = dt.decode_tables_reference(torch.from_numpy(rows), tn, tt, block // 128)
    np.testing.assert_array_equal(got.numpy().reshape(n, block), want)
    assert got.numpy().tobytes() == b"".join(datas)


@pytest.mark.parametrize("codec", ["lz4", "snappy"])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_tables_reference_decodes_the_host_codecs_bytes_at_1mib(corpus, codec):
    # Blocks of up to thousands of sequences (the text corpus's): the JAX
    # B2's interpret mode would take minutes on them, so the plain version
    # is held to the host codec's input bytes instead.
    block = 1 << 20
    data = CORPORA[corpus](16)
    datas = [data[i * block:(i + 1) * block] for i in range(2)]
    rows, tables, nseq, _ = dt.parser_tables(datas, codec)
    assert int(nseq.min()) > (1000 if corpus == "text" else 5)
    tn, tt = dt.table_tensors(tables, nseq, "cpu")
    assert bool(dt.well_formed(tn, tt).all())
    got = dt.decode_tables_reference(torch.from_numpy(rows), tn, tt, block // 128)
    assert got.numpy().tobytes() == b"".join(datas)


def skewed_sizes(block: int, n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    sizes = np.minimum(block, np.exp2(rng.uniform(np.log2(4096), np.log2(block), n)))
    return [int(s) for s in sizes.astype(np.int64)]


@pytest.mark.parametrize("shape", ["uniform", "skewed"])
@pytest.mark.parametrize("block", [256 * KIB, 1024 * KIB])
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_engine_parity_at_large_blocks(codec, block, shape):
    # Containers equal byte for byte; the port decodes its own unit and the
    # JAX engine's container, and the JAX engine (host path) decodes the
    # port's.
    corpus = make_text_corpus(16) if codec == "snappy" else make_corpus(16)
    if shape == "uniform":
        sizes = None
        data = corpus[:2 * block + 5000]
    else:
        sizes = skewed_sizes(block, 5, seed=block // KIB)
        data = corpus[:sum(sizes)]
    jc, tc = CODECS[codec]
    port, ref = port_engine(block, tc), jax_engine(block, jc, use_tpu_kernels=False)
    tu, ju = port.compress(data, sizes=sizes), ref.compress(data, sizes=sizes)
    blob = tu.to_host().to_bytes()
    assert blob == ju.to_host().to_bytes()
    out, status = port.decompress_status(tu)
    assert (status == 0).all() and out.tobytes() == data
    assert port.stats.host_decode_bursts == 0 and tu.plan_flat is not None
    assert tu.plan_flat["host_blocks"].size == 0
    theirs = port.import_unit(btt.CompressedBuffers.from_bytes(ju.to_host().to_bytes()))
    assert port.decompress(theirs).tobytes() == data
    mine = ref.import_unit(bt.CompressedBuffers.from_bytes(blob))
    assert ref.decompress(mine).tobytes() == data
    port.release()
    ref.release()


def test_decode_flat_launch_geometry_by_plane_height():
    # B1: one CTA a block up to 1024 rows (the shared route), else a
    # cluster of one CTA per 1024 rows (2 at 256 KiB, 8 at 1 MiB), none
    # past 8192 rows.
    for rows in range(128, 8193, 128):
        want = 1 if rows <= 1024 else -(-rows // 1024)
        assert df.cluster_ctas(rows) == want, rows
    assert df.cluster_ctas(2048) == 2 and df.cluster_ctas(8192) == 8
    assert df.cluster_ctas(8192 + 128) == 0 and df.cluster_ctas(0) == 0


def test_decode_tables_launch_geometry_by_plane_height():
    # B2: one CTA a block while the plane fits in 227 KiB of shared memory
    # beside two windows of 256 entries (20 bytes each) and a 64 KiB map,
    # that is up to 1224 rows; else a cluster of 2, 4 or 8 CTAs, the least
    # that holds the plane in 128 KiB each (its 1 KiB stripes are dealt
    # round the cluster); none past 1 MiB.
    for rows in range(128, 8193, 128):
        if rows * 128 + 2 * 256 * 20 + 65536 <= 232448:
            want = 1
        else:
            want = 2 if rows <= 2048 else 4 if rows <= 4096 else 8
        assert dt.cluster_ctas(rows) == want, rows
    assert dt.cluster_ctas(1224) == 1 and dt.cluster_ctas(1225) == 2
    assert dt.cluster_ctas(3072) == 4 and dt.cluster_ctas(8192) == 8
    # Small planes keep the shared route (fewer threads, a smaller window).
    assert all(dt.cluster_ctas(r) == 1 for r in range(1, 128))
    assert dt.cluster_ctas(8193) == 0 and dt.cluster_ctas(0) == 0


def test_h100_record_takes_1mib_and_refuses_2mib():
    caps = tconfig.cuda_capabilities("NVIDIA H100 80GB HBM3", 80 << 30, 232448)
    for block in (256 * KIB, 1 << 20):
        cfg = btt.EngineConfig(block_size=block, burst_size=2048, max_pool_slots=2048)
        assert cfg.validate(caps).ok(), block
    st = btt.EngineConfig(block_size=2 << 20).validate(caps)
    assert not st.ok() and "[1024, 1048576]" in st.message
    # The JAX package's TPU record has the same range.
    assert caps.max_block_size == bt.config.TPU_V5E.max_block_size
