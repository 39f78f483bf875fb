"""Kernels #6 and #7's cluster design on the CPU: the tile-to-rank plan,
a float32 model of what the CUDA body computes, and the wrappers' input
dtypes.

The body (paddle_tpu_torch/csrc/decode_stream.cuh) runs one cluster of
`ranks` CTAs per (batch, head): 16-row tiles go to rank t % ranks, each of
a CTA's 4 warps keeps an online softmax over 4 rows of every tile, the
warps merge in warp order and rank 0 merges the ranks in rank order.  The
model below does exactly that in torch, and must equal the plain versions
and the Pallas kernels in interpret mode within 1e-5 (float32: sums taken
in other orders).  Inputs are numpy arrays made from a seed.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops.cuda import decode_stream as ds
from paddle_tpu_torch.ops.cuda import flash_decode as pfd
from paddle_tpu_torch.ops.cuda import flash_decode_paged as pfdp

ATOL = 1e-5
WARPS, ROWS = 4, ds.TILE // 4


# ------------------------------------------------------------- the plan


def _plan_cases():
    cases = []
    for bs, m in ((16, 16), (32, 8), (16, 3), (32, 1), (16, 1)):
        reach = m * bs
        for length in sorted({0, 1, bs - 1, bs, bs + 1, reach - 1, reach,
                              reach + 5, -3}):
            cases.append((bs, m, length))
    return cases


@pytest.mark.parametrize("bs,m,length", _plan_cases())
def test_every_live_key_has_exactly_one_rank(bs, m, length):
    reach = m * bs
    ranks = ds.cluster_ranks(reach)
    tiles = ds.rank_tiles(length, reach, ranks)
    live = min(reach, max(0, length))
    assert len(tiles) == ranks
    owner = {}
    for r, mine in enumerate(tiles):
        assert mine == sorted(mine)
        assert len(mine) <= ds.table_slots(reach, ranks)
        for t in mine:
            assert t % ranks == r
            assert t * ds.TILE < live          # no dead tile is copied
            for key in range(t * ds.TILE, min(live, (t + 1) * ds.TILE)):
                assert key not in owner
                owner[key] = r
    assert sorted(owner) == list(range(live))  # and every live key is
    if 0 < live <= bs and bs == ds.TILE:       # a row within one page
        assert set(owner.values()) == {0}      # lives on rank 0 alone


@pytest.mark.parametrize("reach", [1, 16, 17, 48, 64, 100, 128, 129, 4096,
                                   1 << 20])
def test_cluster_size_is_a_power_of_two_that_covers_short_reaches(reach):
    ranks = ds.cluster_ranks(reach)
    tiles = math.ceil(reach / ds.TILE)
    assert ranks & (ranks - 1) == 0 and 1 <= ranks <= ds.CLUSTER
    assert ranks == ds.CLUSTER or ranks >= tiles
    assert ds.table_slots(reach, ranks) * ranks >= tiles


def test_lengths_go_through_float32_then_int32():
    """As the Pallas kernels' astype chain: truncation, float32 rounding
    past 2**24, then the clamp into [0, reach]."""
    assert ds.live_keys(16.9, 100) == 16
    assert ds.live_keys(2 ** 24 + 1, 2 ** 25) == 2 ** 24
    assert ds.live_keys(-2.5, 10) == 0
    assert ds.live_keys(500, 100) == 100


# ------------------------------------------------------------ the model


def _online(m, l, acc, s, v):
    """One warp's online-softmax update with its live rows' scores s and
    V rows v (float32; P in V's dtype, which is float32 here)."""
    m_new = torch.maximum(m, s.max())
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    return m_new, l * alpha + p.sum(), acc * alpha + p @ v


def _merge(parts):
    """(m, l, acc) partials merged in order; an empty one (m = -inf)
    weighs 0."""
    mx = max(p[0] for p in parts)
    l = torch.zeros(())
    acc = torch.zeros_like(parts[0][2])
    for m, pl, pacc in parts:
        sc = torch.zeros(()) if m == -math.inf else torch.exp(m - mx)
        l = l + pl * sc
        acc = acc + pacc * sc
    return mx, l, acc


def _model_row(q, rows, live, reach):
    """O for one (batch, head): q [D] (scaled), rows(j) -> (k_j, v_j)."""
    ranks = ds.cluster_ranks(reach)
    d = q.shape[0]
    per_rank = []
    for mine in ds.rank_tiles(live, reach, ranks):
        warps = [(torch.tensor(-math.inf), torch.zeros(()), torch.zeros(d))
                 for _ in range(WARPS)]
        for t in mine:
            for w in range(WARPS):
                keys = [j for j in range(t * ds.TILE + w * ROWS,
                                         t * ds.TILE + (w + 1) * ROWS)
                        if j < live]
                if not keys:
                    continue
                k = torch.stack([rows(j)[0] for j in keys])
                v = torch.stack([rows(j)[1] for j in keys])
                warps[w] = _online(*warps[w], k @ q, v)
        per_rank.append(_merge(warps))
    _, l, acc = _merge(per_rank)                # in rank order
    return acc / l if l > 0 else torch.zeros(d)


def _model_dense(q, k, v, h, kv_len):
    b, sk, hd = k.shape
    d = hd // h
    out = torch.zeros(b, 1, hd)
    for bi in range(b):
        live = ds.live_keys(kv_len[bi], sk)
        for hi in range(h):
            cols = slice(hi * d, (hi + 1) * d)
            out[bi, 0, cols] = _model_row(
                q[bi, 0, cols] * (1.0 / d ** 0.5),
                lambda j: (k[bi, j, cols], v[bi, j, cols]), live, sk)
    return out


def _model_paged(q, kb, vb, table, lengths, h):
    n, bs, hd = kb.shape
    d = hd // h
    reach = table.shape[1] * bs
    out = torch.zeros(q.shape[0], 1, hd)
    for bi in range(q.shape[0]):
        live = ds.live_keys(lengths[bi], reach)
        for hi in range(h):
            cols = slice(hi * d, (hi + 1) * d)

            def rows(j):
                blk = min(max(int(table[bi, j // bs]), 0), n - 1)
                return kb[blk, j % bs, cols], vb[blk, j % bs, cols]

            out[bi, 0, cols] = _model_row(q[bi, 0, cols] * (1.0 / d ** 0.5),
                                          rows, live, reach)
    return out


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("d", [64, 128])
def test_model_matches_flash_decode_plain_and_pallas(d):
    rng = np.random.RandomState(31 + d)
    b, sk, h = 4, 200, 2
    q, k, v = (_f32(rng, b, s, h * d) for s in (1, sk, sk))
    kv_len = np.asarray([0, 9, 130, 200], np.int64)   # an empty row
    t = [torch.as_tensor(x) for x in (q, k, v, kv_len)]
    model = _model_dense(*t[:3], h, kv_len)
    plain = pfd.flash_decode_reference(*t[:3], h, kv_len=t[3])
    pallas = np.asarray(jfa.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, interpret=True,
        kv_len=jnp.asarray(kv_len, jnp.float32)))
    np.testing.assert_allclose(model.numpy(), plain.numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(model.numpy(), pallas, rtol=0, atol=ATOL)
    assert not model[0].any()


def _pool(seed, b, n, bs, m, h, d, lengths):
    rng = np.random.RandomState(seed)
    q, kb, vb = (_f32(rng, b, 1, h * d), _f32(rng, n, bs, h * d),
                 _f32(rng, n, bs, h * d))
    table = rng.permutation(n)[:b * m].reshape(b, m).astype(np.int64)
    return q, kb, vb, table, np.asarray(lengths, np.int64)


@pytest.mark.parametrize("d,bs,m,lengths", [
    (64, 16, 10, [0, 16, 17, 160]),    # an empty row, one page, the reach
    (128, 32, 3, [5, 33, 96]),         # 32-row pages: two tiles a page
    (64, 16, 2, [20, 1]),              # a reach of 2 pages: 2 ranks
], ids=["d64", "d128_bs32", "two_pages"])
def test_model_matches_flash_decode_paged_plain_and_pallas(d, bs, m,
                                                           lengths):
    b, h = len(lengths), 2
    q, kb, vb, table, kl = _pool(41 + d + m, b, b * m + 3, bs, m, h, d,
                                 lengths)
    # junk past each row's length: ids past the pool, negative, repeated
    for row, n_live in enumerate(lengths):
        first_dead = -(-n_live // bs)
        junk = [10 ** 6, -4, 0] + [1] * m
        table[row, first_dead:] = junk[:m - first_dead]
    t = [torch.as_tensor(x) for x in (q, kb, vb, table, kl)]
    model = _model_paged(t[0], t[1], t[2], table, kl, h)
    plain = pfdp.flash_decode_paged_reference(*t, h)
    pallas = np.asarray(jfa.flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
        jnp.asarray(table, jnp.int32), jnp.asarray(kl, jnp.int32), h,
        interpret=True))
    np.testing.assert_allclose(model.numpy(), plain.numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(model.numpy(), pallas, rtol=0, atol=ATOL)
    for row, n_live in enumerate(lengths):
        if n_live == 0:
            assert not model[row].any()


# ------------------------------------------------- the wrappers' inputs


def test_paged_wrapper_takes_int64_int32_tables_and_any_length_dtype():
    q, kb, vb, table, kl = _pool(51, 3, 12, 16, 4, 2, 64, [0, 30, 64])
    q, kb, vb = (torch.as_tensor(x) for x in (q, kb, vb))
    ref = pfdp.flash_decode_paged(q, kb, vb, torch.as_tensor(table),
                                  torch.as_tensor(kl), 2)
    for tab in (np.int64, np.int32):
        for lens in (np.int64, np.int32, np.float32):
            out = pfdp.flash_decode_paged(
                q, kb, vb, torch.as_tensor(table.astype(tab)),
                torch.as_tensor(kl.astype(lens)), 2)
            assert torch.equal(out, ref)


def test_dense_wrapper_takes_any_length_dtype():
    rng = np.random.RandomState(52)
    q, k, v = (torch.as_tensor(_f32(rng, 3, s, 128)) for s in (1, 70, 70))
    kl = np.asarray([0, 33, 70], np.int64)
    ref = pfd.flash_decode(q, k, v, 2, kv_len=torch.as_tensor(kl))
    for lens in (np.int32, np.float32):
        out = pfd.flash_decode(q, k, v, 2,
                               kv_len=torch.as_tensor(kl.astype(lens)))
        assert torch.equal(out, ref)
