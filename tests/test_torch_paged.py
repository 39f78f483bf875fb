"""The paged KV half of the serving slice against the JAX package: the
paged append and its op, the paged attention reference, kernel #7's plain
version against the Pallas kernel in interpret mode, the two block pools,
and the paged step-program rewrite.

Inputs are numpy arrays made from a seed.  The append, its op and the
pools are exact (array_equal); the paged reference is held to 1e-6 and
kernel #7 to 1e-5 in float32 (two float32 softmax orders) and 2e-2 in
bfloat16 (the Pallas kernel rounds each block's unnormalised P to
bfloat16 against its running max, the plain version against the row's
final max).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops import attention_ops as jattn
from paddle_tpu.ops import kv_cache as jkv
from paddle_tpu.ops import registry as jreg
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.serving import paged as jpaged
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch import testing
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops import attention_ops as pattn
from paddle_tpu_torch.ops import kv_cache as pkv
from paddle_tpu_torch.ops import registry as preg
from paddle_tpu_torch.ops.cuda import flash_decode_paged as pfdp
from paddle_tpu_torch.serving import paged as ppaged

SMALL = dict(src_vocab_size=64, trg_vocab_size=64, n_layer=2, n_head=2,
             d_model=128, d_inner=256, dropout=0.0)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield
    for f in (jflags, pflags):
        f.reset("flash_attention")


# ------------------------------------------------------------ the append


def _append_case(seed, t):
    """A pool, new rows and a table whose rows cover: an ordinary write, a
    block id past the pool (drops), a negative id (wraps, as NumPy
    indexing does), a cursor past the table's reach (drops), and two pad
    rows that duplicate row 0 (same table, same cursor, same values)."""
    rng = np.random.RandomState(seed)
    n, bs, hd, m = 6, 4, 3, 3
    pool = rng.standard_normal((n, bs, hd)).astype(np.float32)
    new = rng.standard_normal((6, t, hd)).astype(np.float32)
    table = np.asarray([[2, 0, 5], [7, 1, 3], [-1, 4, 0], [1, 2, 3],
                        [2, 0, 5], [2, 0, 5]], np.int64)
    lengths = np.asarray([3, 2, 1, 3 * bs - t + 1, 3, 3], np.int64)
    new[4:] = new[0]
    return pool, new, table, lengths


@pytest.mark.parametrize("t", [1, 2])
def test_append_paged_matches_jax_exactly(t):
    pool, new, table, lengths = _append_case(3 + t, t)
    ref = np.asarray(jkv.append_paged(jnp.asarray(pool), jnp.asarray(new),
                                      table, lengths))
    out = pkv.append_paged(torch.as_tensor(pool.copy()), torch.as_tensor(new),
                           torch.as_tensor(table), torch.as_tensor(lengths))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert not np.array_equal(ref, pool)


def _append_paged_loop(blocks, new, table, lengths):
    """The per-row-of-the-window loop that append_paged replaced: one
    masked store per window position t."""
    n, bs = blocks.shape[0], blocks.shape[1]
    b, m = table.shape
    rows = torch.arange(b)
    for t in range(new.shape[1]):
        pos = lengths + t
        slot = torch.div(pos, bs, rounding_mode="floor")
        in_table = (slot >= 0) & (slot < m)
        blk = table[rows, slot.clamp(0, m - 1)]
        blk = torch.where(blk < 0, blk + n, blk)
        keep = in_table & (blk >= 0) & (blk < n)
        blocks[blk[keep], (pos % bs)[keep]] = new[keep, t]
    return blocks


def _window_case(seed, t):
    """A chunk-sized window: 6 rows over a 128-block pool of 16-row
    blocks, 36 table columns, disjoint block ids per row except the pad
    rows 4 and 5, which repeat row 0 (same table, cursor and values).
    Row 1 holds a negative id (wraps to 127), row 2's cursor runs past its
    table (the tail drops), row 3's table ends in ids past the pool
    (drop)."""
    rng = np.random.RandomState(seed)
    n, bs, hd, m = 128, 16, 3, 36
    pool = rng.standard_normal((n, bs, hd)).astype(np.float32)
    new = rng.standard_normal((6, t, hd)).astype(np.float32)
    table = np.zeros((6, m), np.int64)
    table[0] = np.arange(0, 36)
    table[1] = np.arange(36, 72)
    table[1, 0] = -1
    table[2] = np.arange(72, 108)
    table[3, :19] = np.arange(108, 127)
    table[3, 19:] = 200
    table[4:] = table[0]
    lengths = np.asarray([10, 5, m * bs - max(t // 2, 1), 250, 10, 10],
                         np.int64)
    new[4:] = new[0]
    return pool, new, table, lengths


@pytest.mark.parametrize("t", [1, 4, 512])
def test_append_paged_one_scatter_matches_the_loop(t):
    """The one-scatter write equals the loop over window positions it
    replaced, and the JAX package's scatter, bitwise, at a window of 1, 4
    and 512 rows, through a wrapped negative id, a cursor past the table
    and ids past the pool (both drop), and replicated pad rows."""
    pool, new, table, lengths = _window_case(40 + t, t)
    args = [torch.as_tensor(a) for a in (new, table, lengths)]
    loop = _append_paged_loop(torch.as_tensor(pool.copy()), *args)
    out = pkv.append_paged(torch.as_tensor(pool.copy()), *args)
    np.testing.assert_array_equal(out.numpy(), loop.numpy())
    ref = np.asarray(jkv.append_paged(jnp.asarray(pool), jnp.asarray(new),
                                      table, lengths))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert not np.array_equal(ref[127], pool[127])   # the wrapped id
    for case in (_append_case(3 + t, t),) if t < 12 else ():
        small = [torch.as_tensor(a) for a in case[1:]]
        np.testing.assert_array_equal(
            pkv.append_paged(torch.as_tensor(case[0].copy()), *small),
            _append_paged_loop(torch.as_tensor(case[0].copy()), *small))


def test_append_paged_op_matches_jax_and_writes_in_place():
    pool, new, table, lengths = _append_case(9, 1)
    ins = {"KBlocks": [pool], "VBlocks": [pool * 2], "K": [new],
           "V": [new * 3], "BlockTable": [table], "Lengths": [lengths]}
    outs = {"OutK": ["ok"], "OutV": ["ov"]}
    jinfo = jreg.get_op_info("kv_cache_append_paged")
    jo = jreg.run_forward(jinfo, {p: [jnp.asarray(a) for a in v]
                                  for p, v in ins.items()}, {},
                          out_names=outs)
    pins = {p: [torch.as_tensor(a.copy()) for a in v]
            for p, v in ins.items()}
    po = preg.run_forward(preg.get_op_info("kv_cache_append_paged"), pins,
                          {}, out_names=outs, device=CPU)
    for p in ("OutK", "OutV"):
        np.testing.assert_array_equal(po[p][0].numpy(), np.asarray(jo[p][0]))
    assert po["OutK"][0] is pins["KBlocks"][0]   # the pool, in place
    assert preg.get_op_info("kv_cache_append_paged").no_grad


# --------------------------------------------------- paged attention


def _pool_case(seed, b, h, d, bs, m, lengths, dtype=np.float32):
    rng = np.random.RandomState(seed)
    hd = h * d
    n = b * m + 3   # a pool larger than any one table
    q = rng.standard_normal((b, 1, hd)).astype(dtype)
    kb = rng.standard_normal((n, bs, hd)).astype(dtype)
    vb = rng.standard_normal((n, bs, hd)).astype(dtype)
    table = rng.permutation(n)[:b * m].reshape(b, m).astype(np.int64)
    return q, kb, vb, table, np.asarray(lengths, np.int64)


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def test_paged_attention_reference_matches_jax():
    b, h, d, bs, max_len = 3, 4, 16, 8, 24
    q, kb, vb, table, kl = _pool_case(11, b, h, d, bs, max_len // bs,
                                      [5, 8, 23])
    table[0, 2] = 99   # a stale entry past the row's length: clipped
    ref = np.asarray(jattn.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb), jnp.asarray(table),
        jnp.asarray(kl), num_heads=h, scale=0.0, max_len=max_len))
    out = pattn.paged_attention_reference(*_t(q, kb, vb, table, kl),
                                          num_heads=h, scale=0.0,
                                          max_len=max_len)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def _jax_paged(q, kb, vb, table, kl, h, dtype="float32"):
    jdt = jnp.dtype(dtype)
    return np.asarray(jfa.flash_decode_paged(
        jnp.asarray(q, jdt), jnp.asarray(kb, jdt), jnp.asarray(vb, jdt),
        jnp.asarray(table, jnp.int32), jnp.asarray(kl, jnp.int32), h,
        interpret=True).astype(jnp.float32))


def _port_paged(q, kb, vb, table, kl, h, dtype=torch.float32):
    q, kb, vb, table, kl = _t(q, kb, vb, table, kl)
    return pfdp.flash_decode_paged(q.to(dtype), kb.to(dtype), vb.to(dtype),
                                   table, kl, h).float().numpy()


@pytest.mark.parametrize("b,h,d,bs,m,lengths", [
    (5, 4, 64, 16, 4, [5, 16, 17, 37, 64]),   # across block edges
    (2, 2, 64, 16, 1, [1, 16]),               # a single block
    (4, 2, 64, 32, 3, [31, 32, 33, 96]),      # bs 32
    (3, 1, 128, 16, 2, [0, 9, 32]),           # an empty row gives 0
], ids=["edges", "single_block", "bs32", "zero_row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_paged_matches_pallas_interpret(b, h, d, bs, m, lengths,
                                                     dtype):
    q, kb, vb, table, kl = _pool_case(b * bs + m, b, h, d, bs, m, lengths)
    ref = _jax_paged(q, kb, vb, table, kl, h, dtype)
    out = _port_paged(q, kb, vb, table, kl, h, getattr(torch, dtype))
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)
    for row, n_live in enumerate(lengths):
        if n_live == 0:
            assert not out[row].any()


def test_stale_table_tail_is_ignored():
    """Entries past ceil(len / bs) are junk by contract: scribbling them
    changes nothing, in either package."""
    q, kb, vb, table, kl = _pool_case(3, 2, 2, 64, 16, 4, [20, 9])
    junk = table.copy()
    junk[0, 2:] = (junk[0, 2:] + 1) % kb.shape[0]
    junk[1, 1:] = 0
    out1 = _port_paged(q, kb, vb, table, kl, 2)
    out2 = _port_paged(q, kb, vb, junk, kl, 2)
    np.testing.assert_array_equal(out1, out2)
    np.testing.assert_allclose(out2, _jax_paged(q, kb, vb, junk, kl, 2),
                               rtol=0, atol=1e-5)


def test_paged_gate_agrees():
    cases = [((2, 1, 256), (8, 16, 256), 4), ((2, 1, 256), (8, 12, 256), 4),
             ((2, 1, 240), (8, 16, 240), 4), ((2, 4, 256), (8, 16, 256), 4),
             ((8, 1, 512), (2560, 16, 512), 8), ((2, 1, 128), (8, 32, 128), 2)]
    for flag in ("auto", "interpret", "0", "force"):
        jflags.set("flash_attention", flag)
        pflags.set("flash_attention", flag)
        for qs, ks, h in cases:
            j = jattn.paged_backend_choice(jnp.zeros(qs), jnp.zeros(ks), h)
            p = pattn.paged_backend_choice(torch.empty(qs, device="meta"),
                                           torch.empty(ks, device="meta"), h)
            assert p == j, (flag, qs, ks, p, j)
            assert pfdp.paged_decode_supported(
                torch.empty(qs, device="meta"),
                torch.empty(ks, device="meta"), h) == \
                jfa.paged_decode_supported(jnp.zeros(qs), jnp.zeros(ks), h)


def test_paged_op_takes_the_kernel_tier_under_interpret():
    pflags.set("flash_attention", "interpret")
    q, kb, vb, table, kl = _pool_case(21, 2, 2, 64, 16, 3, [40, 3])
    pattn.TIER_CALLS.clear()
    kw = dict(num_heads=2, scale=0.0, max_len=48)
    out = pattn._apply_attention_paged(*_t(q, kb, vb, table, kl), **kw)
    pflags.set("flash_attention", "0")
    ref = pattn._apply_attention_paged(*_t(q, kb, vb, table, kl), **kw)
    assert dict(pattn.TIER_CALLS) == {"flash_decode_paged": 1,
                                      "paged_reference": 1}
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    # a ramp window always takes the paged reference, kernel gate or not;
    # at Sq = 1 its mask is the SeqLen mask, so it gives the reference's
    # output bitwise
    pflags.set("flash_attention", "interpret")
    ramp = pattn._apply_attention_paged(*_t(q, kb, vb, table, kl),
                                        seq_len_ramp=True, **kw)
    assert pattn.TIER_CALLS["paged_reference"] == 2
    np.testing.assert_array_equal(ramp.numpy(), ref.numpy())


# ---------------------------------------------------------------- pools


def _pool(kind, num_blocks=8, block_size=4):
    p = (pkv.BlockPool(num_blocks, block_size) if kind == "host"
         else pkv.DeviceBlockPool(num_blocks, block_size, device=CPU))
    p.add_stream("k", (2,), np.float32)
    return p


KINDS = pytest.mark.parametrize("kind", ["host", "device"])


@KINDS
def test_alloc_release_refcount(kind):
    p = _pool(kind)
    blocks = p.alloc(3)
    assert p.used_blocks() == 3 and p.free_blocks() == 5
    p.retain(blocks)
    p.release(blocks)
    assert p.used_blocks() == 3
    p.release(blocks)
    assert p.used_blocks() == 0 and p.free_blocks() == 8
    with pytest.raises(ValueError):
        p.release(blocks)


@KINDS
def test_write_gather_roundtrip_and_zero_padding(kind):
    p = _pool(kind)
    blocks = p.alloc(2)
    rows = np.arange(6 * 2, dtype=np.float32).reshape(6, 2)
    p.write_rows("k", blocks, 0, rows)
    out = p.gather("k", blocks, 6, pad_to=12)
    assert out.shape == (12, 2) and isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out[:6], rows)
    assert np.count_nonzero(out[6:]) == 0
    # a write from a mid-block cursor, and one past the table's reach
    p.write_rows("k", blocks, 5, rows[:3] + 100)
    np.testing.assert_array_equal(p.gather("k", blocks, 8, 8)[5:],
                                  rows[:3] + 100)
    with pytest.raises(IndexError, match="beyond table"):
        p.write_rows("k", blocks, 7, rows[:2])


@KINDS
def test_clone_block_cow(kind):
    p = _pool(kind)
    (b,) = p.alloc(1)
    p.write_row("k", [b], 0, np.array([1.0, 2.0], np.float32))
    c = p.clone_block(b)
    assert c != b
    p.write_row("k", [c], 0, np.array([9.0, 9.0], np.float32))
    np.testing.assert_array_equal(p.gather("k", [b], 1, 1)[0], [1.0, 2.0])
    np.testing.assert_array_equal(p.gather("k", [c], 1, 1)[0], [9.0, 9.0])


@KINDS
def test_prefix_register_lookup_evict(kind):
    p = _pool(kind)
    blocks = p.alloc(2)
    p.register_prefix("key", blocks, 5, {"x": 1})
    assert not p.register_prefix("key", blocks, 5)   # first writer wins
    b2, n, aux = p.lookup_prefix("key")
    assert list(b2) == list(blocks) and n == 5 and aux == {"x": 1}
    assert p.lookup_prefix("nope") is None
    st = p.stats()
    assert st["prefix_hits"] == 1 and st["prefix_misses"] == 1
    p.release(blocks)
    p.release(blocks)
    assert p.used_blocks() == 2   # the registry still holds its ref
    p.evict_prefix("key")
    assert p.used_blocks() == 0


@KINDS
def test_exhaustion_evicts_idle_prefixes_lru_then_raises(kind):
    p = _pool(kind, num_blocks=4)
    a = p.alloc(2)
    p.register_prefix("a", a, 8, None)
    p.release(a)   # only the registry holds it: idle, evictable
    b = p.alloc(2)
    p.register_prefix("b", b, 8, None)   # pinned by its live owner
    got = p.alloc(2)
    assert len(got) == 2 and p.stats()["prefix_evictions"] == 1
    assert p.lookup_prefix("a") is None
    with pytest.raises(pkv.PoolExhausted):
        p.alloc(1)


@KINDS
def test_assert_quiesced(kind):
    p = _pool(kind)
    a = p.alloc(2)
    p.register_prefix("a", a, 6, None)
    with pytest.raises(AssertionError, match="not quiesced"):
        p.assert_quiesced()
    p.release(a)
    assert p.assert_quiesced()["used_blocks"] == 0


@KINDS
def test_multi_stream_group_write_and_export_adopt(kind):
    p = _pool(kind, num_blocks=8, block_size=4)
    p.add_stream("v", (2,), np.float32)
    a, b = p.alloc(2), p.alloc(1)
    ra = np.arange(14, dtype=np.float32).reshape(7, 2)
    rb = -np.arange(6, dtype=np.float32).reshape(3, 2)
    jobs = [(a, 0, ra), (b, 1, rb)]
    p.write_rows_multi({"k": jobs, "v": [(a, 0, ra * 2)]})
    np.testing.assert_array_equal(p.gather("k", a, 7, 7), ra)
    np.testing.assert_array_equal(p.gather("k", b, 4, 4)[1:], rb)
    np.testing.assert_array_equal(p.gather("v", a, 7, 7), ra * 2)
    payload = p.export_rows(a, 7)
    c = p.adopt_rows(payload, 7)
    np.testing.assert_array_equal(p.gather("v", c, 7, 7), ra * 2)


def test_device_pool_streams_are_tensors_in_place():
    p = _pool("device")
    s = p.stream("k")
    assert isinstance(s, torch.Tensor) and s.device == CPU
    blocks = p.alloc(1)
    p.write_rows("k", blocks, 0, torch.ones(3, 2))
    assert p.stream("k") is s and s[blocks[0], :3].eq(1).all()
    p.set_stream("k", s)
    with pytest.raises(ValueError, match="expected"):
        p.set_stream("k", torch.zeros(8, 4, 3))
    with pytest.raises(ValueError, match="expected"):
        p.set_stream("k", s.double())


def test_device_pool_defaults_to_the_card():
    if torch.cuda.is_available():
        assert pkv.DeviceBlockPool(4, 4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CPUPlace"):
            pkv.DeviceBlockPool(4, 4)


# ------------------------------------------------ the step-program rewrite


def test_build_paged_step_matches_jax():
    """The rewritten step program's dict equals the JAX package's: op
    types, inputs, attrs (paged_max_len) and var shapes."""
    with junique.guard():
        jspec = JT.build_decode(JT.TransformerConfig(**SMALL), src_len=128,
                                prefix_len=8, max_len=256)
    pspec = PT.build_decode(PT.TransformerConfig(**SMALL), src_len=128,
                            prefix_len=8, max_len=256)
    jd = jpaged.build_paged_step(jspec, 16, 48).to_dict()["blocks"][0]
    pprog = ppaged.build_paged_step(pspec, 16, 48)
    pd = pprog.to_dict()["blocks"][0]
    assert [o["type"] for o in pd["ops"]] == [o["type"] for o in jd["ops"]]
    assert sum(o["type"] == "kv_cache_append_paged" for o in pd["ops"]) == 2
    for jo, po in zip(jd["ops"], pd["ops"]):
        assert po["inputs"] == jo["inputs"], jo["type"]
        assert po["outputs"] == jo["outputs"], jo["type"]
        assert po["attrs"] == jo["attrs"], jo["type"]
    assert {v["name"]: v for v in pd["vars"]} == \
        {v["name"]: v for v in jd["vars"]}
    # the spec's own step program is left as it was
    assert not any(op.type == "kv_cache_append_paged"
                   for op in pspec.step_program.global_block().ops)
