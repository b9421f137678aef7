"""Port kernels vs the JAX package on the CPU: the PyTorch wrappers (which
run their plain versions on CPU tensors) against the Pallas kernels in
interpret mode and against the JAX package's own oracles, on the same
numpy inputs.

Tolerances: every comparison is in float32, where the two sides differ
only in summation order (online softmax over tiles vs one softmax over the
row), so 2e-5 — the bound ``tests/test_kernels.py`` uses for float32 — is
ample; the garbage-block case is exact up to 1e-6, as there. The WKV
recurrence (chunked against sequential) is held to 1e-5 of the output's
scale, the bound of ``tests/test_kernels.py::test_wkv_kernel``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jax_dec_ops
from repro.kernels.decode_attention.decode_attention import \
    decode_attention_kernel
from repro.kernels.decode_attention.paged_decode import \
    paged_decode_attention_kernel
from repro.kernels.decode_attention.ref import (decode_attention_paged_ref,
                                                decode_attention_ref)
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.rwkv6.ops import wkv as jax_wkv
from repro.kernels.rwkv6.ref import wkv_ref as jax_wkv_ref
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref as port_decode_attention_ref,
    dense_decode_partials_ref, paged_decode_partials_ref)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rwkv6.ops import wkv
from repro_torch.kernels.rwkv6.ref import wkv_chunked, wkv_step
from repro_torch.kernels.rwkv6.ref import wkv_ref as port_wkv_ref

TOL = 2e-5      # float32, summation order only
NEG_INF = -1e30


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,dh,causal,off,block", [
    (2, 128, 128, 4, 2, 64, True, 0, 64),        # GQA, causal
    (1, 128, 128, 16, 2, 128, True, 0, 64),      # qwen2.5-3b head geometry
    (2, 64, 192, 2, 1, 64, True, 128, 64),       # q_offset > 0, Sq != Skv
    (1, 128, 128, 8, 2, 64, False, 0, 64),       # full (non-causal)
    (1, 48, 48, 4, 2, 128, True, 0, 16),         # ragged: 48 % 64 != 0
    (1, 40, 104, 16, 2, 128, True, 64, 8),       # ragged chunk at an offset
])
def test_flash_attention_matches_jax(B, Sq, Skv, H, Hkv, dh, causal, off,
                                     block):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, Sq, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, dh)).astype(np.float32)
    n0 = flash_attention.launches
    out = flash_attention(_t(q), _t(k), _t(v), causal=causal, q_offset=off)
    assert flash_attention.launches == n0       # CPU: plain version only
    assert out.shape == (B, Sq, H, dh) and out.dtype == torch.float32
    # the TPU kernel needs Sq, Skv to be multiples of its tiles: the JAX
    # side takes tiles that divide the ragged lengths
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, q_offset=off, block_q=block,
                       block_kv=block, interpret=True)
    ref = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, q_offset=off)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_flash_attention_ref_keeps_dtype_and_masks_empty_rows():
    """bf16 in -> bf16 out; a row that sees no key gives 0, not NaN, as
    the kernels' finite NEG_INF and m > 0.5*NEG_INF guard do."""
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((1, 4, 2, 16)).astype(np.float32))
    k = _t(rng.standard_normal((1, 4, 1, 16)).astype(np.float32))
    out = flash_attention_ref(q.bfloat16(), k.bfloat16(), k.bfloat16())
    assert out.dtype == torch.bfloat16
    # row 0 sits at position -1: every key lies in its causal future
    s = flash_attention_ref(q, k, k, causal=True, q_offset=-1)
    assert torch.isfinite(s).all() and float(s[0, 0].abs().max()) == 0.0


@pytest.mark.parametrize("B,Smax,H,Hkv,dh,bk", [   # tests/test_kernels.py:44
    (2, 256, 8, 2, 64, 64),
    (3, 512, 4, 4, 128, 128),
    (2, 128, 16, 1, 64, 64),
    (1, 1024, 8, 8, 64, 256),
])
def test_decode_attention_matches_jax(B, Smax, H, Hkv, dh, bk):
    rng = np.random.default_rng(21)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    kc = rng.standard_normal((B, Smax, Hkv, dh)).astype(np.float32)
    vc = rng.standard_normal((B, Smax, Hkv, dh)).astype(np.float32)
    lens = rng.integers(1, Smax + 1, B).astype(np.int32)
    n0 = dec_ops.decode_attention.launches
    out = dec_ops.decode_attention(_t(q), _t(kc), _t(vc), _t(lens))
    assert dec_ops.decode_attention.launches == n0     # CPU: plain only
    assert out.shape == (B, H, dh) and out.dtype == torch.float32
    pallas = jax_dec_ops.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        block_kv=bk, interpret=True)
    ref = decode_attention_ref(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_decode_attention_engine_shape_and_edge_lengths():
    """qwen2.5-3b's heads at the dense engine's capacity (584, no multiple
    of a split), lengths 1 and Smax, and past Smax (all rows live), against
    the JAX oracle; a row of length 0 gives 0, as the kernel does."""
    rng = np.random.default_rng(23)
    B, Smax, H, Hkv, dh = 4, 584, 16, 2, 128
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    kc = rng.standard_normal((B, Smax, Hkv, dh)).astype(np.float32)
    vc = rng.standard_normal((B, Smax, Hkv, dh)).astype(np.float32)
    lens = np.array([1, 584, 300, 700], np.int32)
    out = dec_ops.decode_attention(_t(q), _t(kc), _t(vc), _t(lens))
    ref = decode_attention_ref(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    zero = port_decode_attention_ref(_t(q), _t(kc), _t(vc),
                                     _t(np.zeros(B, np.int32)))
    assert float(zero.abs().max()) == 0.0
    assert port_decode_attention_ref(_t(q).bfloat16(), _t(kc).bfloat16(),
                                     _t(vc).bfloat16(), _t(lens)).dtype == \
        torch.bfloat16


def test_decode_attention_length_mask_exact():
    """Rows past a length must not leak (``tests/test_kernels.py:64``):
    poisoning them changes nothing, here and in the JAX kernel."""
    rng = np.random.default_rng(25)
    B, Smax, H, Hkv, dh = 2, 128, 4, 2, 64
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    kc = rng.standard_normal((B, Smax, Hkv, dh)).astype(np.float32)
    vc = rng.standard_normal((B, Smax, Hkv, dh)).astype(np.float32)
    lens = np.array([40, 100], np.int32)
    out1 = dec_ops.decode_attention(_t(q), _t(kc), _t(vc), _t(lens))
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[0, 40:], vc2[0, 40:] = 99.0, -99.0
    kc2[1, 100:], vc2[1, 100:] = 1e4, -1e4
    out2 = dec_ops.decode_attention(_t(q), _t(kc2), _t(vc2), _t(lens))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)
    jout = jax_dec_ops.decode_attention(
        jnp.asarray(q), jnp.asarray(kc2), jnp.asarray(vc2),
        jnp.asarray(lens), block_kv=64, interpret=True)
    np.testing.assert_allclose(out2.numpy(), np.asarray(jout), atol=TOL,
                               rtol=TOL)


def _paged_case(rng, B, N, Bs, Hkv, dh, lengths):
    """Pool + sequential per-sequence tables; pad columns -> trash block 0
    (the layout of ``tests/test_kernels.py``)."""
    pool_k = rng.standard_normal((N, Bs, Hkv, dh)).astype(np.float32)
    pool_v = rng.standard_normal((N, Bs, Hkv, dh)).astype(np.float32)
    nb = max(-(-int(n) // Bs) for n in lengths)
    tables = np.zeros((B, nb), np.int32)
    ids = iter(range(1, N))
    for b, n in enumerate(lengths):
        for j in range(-(-int(n) // Bs)):
            tables[b, j] = next(ids)
    return pool_k, pool_v, tables


PAGED_CASES = [                                  # tests/test_kernels.py:92
    (2, 8, 2, 64, 16, 32, (37, 16)),
    (3, 4, 4, 128, 32, 16, (64, 1, 90)),
    (1, 16, 1, 64, 8, 64, (100,)),
    (2, 8, 8, 64, 64, 8, (64, 128)),
]


@pytest.mark.parametrize("B,H,Hkv,dh,Bs,N,lengths", PAGED_CASES + [
    (4, 16, 2, 128, 8, 64, (129, 1, 64, 77)),    # qwen2.5-3b geometry,
])                                               # engine block size 8
def test_decode_attention_paged_matches_jax(B, H, Hkv, dh, Bs, N, lengths):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    pool_k, pool_v, tables = _paged_case(rng, B, N, Bs, Hkv, dh, lengths)
    lens = np.asarray(lengths, np.int32)
    n0 = dec_ops.decode_attention_paged.launches
    out = dec_ops.decode_attention_paged(_t(q), _t(pool_k), _t(pool_v),
                                         _t(tables), _t(lens))
    assert dec_ops.decode_attention_paged.launches == n0
    pallas = jax_dec_ops.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True)
    ref = decode_attention_paged_ref(q, pool_k, pool_v, tables, lens)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_decode_attention_paged_garbage_block_immunity():
    """Trash-block contents and positions past a length must not leak
    (``tests/test_kernels.py:113``): poisoning them changes nothing."""
    rng = np.random.default_rng(13)
    B, H, Hkv, dh, Bs, N = 2, 4, 2, 64, 16, 16
    lengths = np.array([20, 33], np.int32)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    pool_k, pool_v, tables = _paged_case(rng, B, N, Bs, Hkv, dh, lengths)
    out1 = dec_ops.decode_attention_paged(_t(q), _t(pool_k), _t(pool_v),
                                          _t(tables), _t(lengths))
    pool_k2, pool_v2 = pool_k.copy(), pool_v.copy()
    pool_k2[0] = 1e4
    pool_v2[0] = -1e4
    for b, n in enumerate(lengths):
        last = tables[b, (int(n) - 1) // Bs]
        pool_k2[last, int(n) % Bs or Bs:] = 77.0
        pool_v2[last, int(n) % Bs or Bs:] = -77.0
    out2 = dec_ops.decode_attention_paged(_t(q), _t(pool_k2), _t(pool_v2),
                                          _t(tables), _t(lengths))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)


@pytest.mark.parametrize("lengths", [(37, 16), (1, 48, 0)])
def test_paged_partials_match_tpu_kernel_partials(lengths):
    """With one table entry per split (the TPU kernel's split), the plain
    partials are the TPU kernel's own (o, m, l), dead splits included:
    (0, NEG_INF, 0), which the merge turns into exact zeros."""
    rng = np.random.default_rng(5)
    B, Hkv, G, dh, Bs, N = len(lengths), 2, 4, 64, 16, 16
    qg = rng.standard_normal((B, Hkv, G, dh)).astype(np.float32)
    pool_k, pool_v, tables = _paged_case(rng, B, N, Bs, Hkv, dh,
                                         [max(n, 1) for n in lengths])
    lens = np.asarray(lengths, np.int32)
    o, m, l = paged_decode_partials_ref(_t(qg), _t(pool_k), _t(pool_v),
                                        _t(tables), _t(lens),
                                        pages_per_split=1)
    jo, jm, jl = paged_decode_attention_kernel(
        jnp.asarray(qg), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(tables), jnp.asarray(lens), scale=1.0 / np.sqrt(dh),
        interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert float(m.min()) == float(np.float32(NEG_INF))   # a dead split
    merged = dec_ops._merge_splits(o, m, l)
    jmerged = jax_dec_ops._merge_splits(jo, jm, jl)
    np.testing.assert_allclose(merged.numpy(), np.asarray(jmerged),
                               atol=TOL, rtol=TOL)
    assert torch.isfinite(merged).all()


def test_merge_splits_matches_jax_on_random_partials():
    rng = np.random.default_rng(9)
    o = rng.standard_normal((2, 2, 5, 4, 8)).astype(np.float32)
    m = rng.standard_normal((2, 2, 5, 4)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (2, 2, 5, 4)).astype(np.float32)
    m[:, :, 3] = NEG_INF                       # dead splits
    l[:, :, 3] = 0.0
    o[:, :, 3] = 0.0
    got = dec_ops._merge_splits(_t(o), _t(m), _t(l))
    want = jax_dec_ops._merge_splits(jnp.asarray(o), jnp.asarray(m),
                                     jnp.asarray(l))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("B,Hkv,nb,Bs,want", [
    (8, 2, 73, 8, 4),        # the serve's decode step: 19 splits, 304 CTAs
    (32, 2, 512, 8, 8),      # B=32 x 4096: 64-token splits, 4,096 CTAs
    (1, 2, 64, 8, 4),        # narrow grid: the fewest tokens, 16 splits
    (140, 2, 4, 8, 8),       # wide batch: 64-token splits are enough
    (4, 2, 3, 64, 1),        # a page of 64 is already >= 32 tokens
    (2, 4, 1, 128, 1),       # one page of 128, more than the 64 cap
    (3, 1, 40, 16, 2),
])
def test_pages_per_split_covers_split_tokens(B, Hkv, nb, Bs, want):
    """Whole pages, at least 32 tokens (or one page), at most 64 (or one
    page), the table covered, and 264 CTAs reached wherever the table
    allows."""
    pps = dec_ops.pages_per_split(B, Hkv, nb, Bs)
    assert pps == want
    T = pps * Bs
    n_splits = -(-nb // pps)
    assert T <= max(dec_ops.MAX_SPLIT_TOKENS, Bs) and n_splits * pps >= nb
    assert T >= dec_ops.MIN_SPLIT_TOKENS or pps == 1
    lo = -(-dec_ops.MIN_SPLIT_TOKENS // Bs)
    if B * Hkv * -(-nb // lo) >= dec_ops.TARGET_CTAS:
        assert B * Hkv * n_splits >= dec_ops.TARGET_CTAS
    with pytest.raises(ValueError):
        dec_ops.pages_per_split(B, Hkv, nb, 256)


@pytest.mark.parametrize("B,Hkv,G,Bs,lengths,splits", [
    (1, 2, 4, 8, (250,), 8),                    # small batch, many splits
    (136, 2, 2, 32, [1 + (7 * b) % 32 for b in range(136)], 1),  # one split
])
def test_paged_split_rule_merges_to_jax(B, Hkv, G, Bs, lengths, splits):
    """The plain partials under the shape's split rule, merged, give the
    JAX package's paged decode (Pallas kernel in interpret mode)."""
    rng = np.random.default_rng(21)
    dh = 64
    q = rng.standard_normal((B, Hkv * G, dh)).astype(np.float32)
    N = 1 + sum(-(-n // Bs) for n in lengths)
    pool_k, pool_v, tables = _paged_case(rng, B, N, Bs, Hkv, dh, lengths)
    lens = np.asarray(lengths, np.int32)
    pps = dec_ops.pages_per_split(B, Hkv, tables.shape[1], Bs)
    assert -(-tables.shape[1] // pps) == splits
    o, m, l = paged_decode_partials_ref(
        _t(q).reshape(B, Hkv, G, dh), _t(pool_k), _t(pool_v), _t(tables),
        _t(lens), pages_per_split=pps)
    assert o.shape == (B, Hkv, splits, G, dh)
    got = dec_ops._merge_splits(o, m, l).reshape(B, Hkv * G, dh)
    out = dec_ops.decode_attention_paged(_t(q), _t(pool_k), _t(pool_v),
                                         _t(tables), _t(lens))
    np.testing.assert_allclose(out.numpy(), got.numpy(), atol=1e-6)
    pallas = jax_dec_ops.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("B,Hkv,Smax,want", [
    (8, 2, 584, 32),         # the dense serve's step: 19 splits, 304 CTAs
    (12, 2, 584, 48),        # 13 splits of 48 reach 312 CTAs
    (16, 2, 584, 64),
    (32, 2, 4096, 64),       # B=32 x 4096: 4,096 CTAs
    (6, 2, 584, 32),         # 228 CTAs at most: the shortest split
    (4, 2, 100, 32),
    (1, 2, 16, 32),          # a cache shorter than one split
    (140, 2, 64, 64),        # wide batch: one split of 64 is enough
])
def test_dense_split_tokens_rule(B, Hkv, Smax, want):
    """A multiple of 16 from 32 to 64 rows, the splits cover Smax, 264
    CTAs reached wherever 32-row splits reach them, and no longer split
    in the range would also reach them."""
    T = dec_ops.split_tokens(B, Hkv, Smax)
    assert T == want
    assert T % 16 == 0
    assert dec_ops.MIN_SPLIT_TOKENS <= T <= dec_ops.MAX_SPLIT_TOKENS
    n_splits = -(-Smax // T)
    assert n_splits * T >= Smax > (n_splits - 1) * T
    if B * Hkv * -(-Smax // dec_ops.MIN_SPLIT_TOKENS) >= dec_ops.TARGET_CTAS:
        assert B * Hkv * n_splits >= dec_ops.TARGET_CTAS
        for longer in range(T + 16, dec_ops.MAX_SPLIT_TOKENS + 1, 16):
            assert B * Hkv * -(-Smax // longer) < dec_ops.TARGET_CTAS
    else:
        assert T == dec_ops.MIN_SPLIT_TOKENS


def test_dense_split_partials_merge_to_jax():
    """qwen2.5-3b's heads (16 query heads on 2 KV heads, dh 128) in the
    dense engine's cache of 584 rows (no multiple of the 32-row split the
    rule gives here), lengths 0, 1, 31, 32, 33 and Smax: the plain
    partials, merged, give the JAX package's ``decode_attention_ref`` for
    every row with a live column (its softmax of an empty row is NaN; the
    port's, like the kernels', is 0) and the Pallas kernel in interpret
    mode at block_kv = 8, which divides 584, for every row. float32,
    summation order only: within 2e-5."""
    rng = np.random.default_rng(27)
    B, Smax, H, Hkv, dh = 6, 584, 16, 2, 128
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    kc = rng.standard_normal((B, Smax, Hkv, dh)).astype(np.float32)
    vc = rng.standard_normal((B, Smax, Hkv, dh)).astype(np.float32)
    lens = np.array([0, 1, 31, 32, 33, Smax], np.int32)
    T = dec_ops.split_tokens(B, Hkv, Smax)
    assert T == 32 and Smax % T
    o, m, l = dense_decode_partials_ref(
        _t(q).reshape(B, Hkv, H // Hkv, dh), _t(kc), _t(vc), _t(lens),
        split_tokens=T)
    assert o.shape == (B, Hkv, -(-Smax // T), H // Hkv, dh)
    assert float(m[0].max()) == float(np.float32(NEG_INF))  # all dead
    got = dec_ops._merge_splits(o, m, l).reshape(B, H, dh)
    assert float(got[0].abs().max()) == 0.0
    ref = decode_attention_ref(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy()[1:], np.asarray(ref)[1:],
                               atol=TOL, rtol=TOL)
    pallas = jax_dec_ops.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        block_kv=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=TOL,
                               rtol=TOL)
    out = dec_ops.decode_attention(_t(q), _t(kc), _t(vc), _t(lens))
    np.testing.assert_allclose(out.numpy(), got.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,Smax,lengths", [
    (4, 256, (0, 1, 32, 256)),      # 8 splits of 32
    (3, 192, (33, 191, 64)),        # 6 splits of 32
])
def test_dense_partials_match_tpu_kernel_partials(B, Smax, lengths):
    """Where the split divides Smax, the plain partials are the TPU
    kernel's own (o, m, l) at block_kv = the split, dead splits included:
    (0, NEG_INF, 0)."""
    rng = np.random.default_rng(31)
    Hkv, G, dh = 2, 8, 64
    qg = rng.standard_normal((B, Hkv, G, dh)).astype(np.float32)
    kc = rng.standard_normal((B, Smax, Hkv, dh)).astype(np.float32)
    vc = rng.standard_normal((B, Smax, Hkv, dh)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    T = dec_ops.split_tokens(B, Hkv, Smax)
    assert Smax % T == 0
    o, m, l = dense_decode_partials_ref(_t(qg), _t(kc), _t(vc), _t(lens),
                                        split_tokens=T)
    jo, jm, jl = decode_attention_kernel(
        jnp.asarray(qg), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        scale=1.0 / np.sqrt(dh), block_kv=T, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


def test_wrappers_check_shapes():
    q = torch.zeros((1, 4, 6, 16))
    with pytest.raises(ValueError):             # 6 q heads, 4 kv heads
        flash_attention(q, torch.zeros((1, 4, 4, 16)),
                        torch.zeros((1, 4, 4, 16)))
    with pytest.raises(ValueError):             # k and v differ
        flash_attention(q, torch.zeros((1, 4, 2, 16)),
                        torch.zeros((1, 5, 2, 16)))


# ---------------------------------------------------------------------------
# RWKV-6 WKV (kernel 4)


def _wkv_inputs(B, S, H, N, seed, strong_decay=False):
    """r, k, v, logw [B,S,H,N], u [H,N], state0 [B,H,N,N] in float32, as
    ``tests/test_kernels.py`` draws them (data-dependent logw <= 0, a
    nonzero state)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    if strong_decay:
        logw = np.full((B, S, H, N), -12.0, np.float32)
    else:
        logw = -np.exp(rng.standard_normal((B, S, H, N)) - 0.5).astype(
            np.float32)
    u = (rng.standard_normal((H, N)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, N)) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


def _jax_wkv_ref(r, k, v, logw, u, s0):
    """The JAX package's sequential oracle, in its [BH,S,N] layout."""
    B, S, H, N = r.shape
    rr, kk, vv, lw = (jnp.asarray(a).transpose(0, 2, 1, 3).reshape(
        B * H, S, N) for a in (r, k, v, logw))
    uu = jnp.broadcast_to(jnp.asarray(u)[None], (B, H, N)).reshape(B * H, N)
    y, s = jax_wkv_ref(rr, kk, vv, lw, uu, jnp.asarray(s0).reshape(
        B * H, N, N))
    return (np.asarray(y).reshape(B, H, S, N).transpose(0, 2, 1, 3),
            np.asarray(s).reshape(B, H, N, N))


def _rel(got, want):
    """max |got - want| over the output's scale (at least 1), the measure
    ``tests/test_kernels.py::test_wkv_kernel`` bounds by 1e-5."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1.0)


@pytest.mark.parametrize("B,S,H,N,chunk", [   # tests/test_kernels.py:136
    (2, 128, 2, 64, 32),
    (1, 96, 4, 32, 32),
    (2, 64, 2, 64, 64),
    (1, 160, 2, 64, 32),     # ragged against the Pallas chunk of 64
    (3, 1, 2, 64, 64),       # one token: the decode step's shape
])
def test_wkv_matches_jax(B, S, H, N, chunk):
    """The port's wrapper (its CPU path, the chunked form) and its
    sequential oracle against the Pallas kernel in interpret mode and the
    JAX package's oracle: float32, summation order only, so within 1e-5 of
    the output's scale (the reference test's bound) for y and the state."""
    args = _wkv_inputs(B, S, H, N, seed=S + N)
    t = [_t(a) for a in args]
    n0 = wkv.launches
    y, s = wkv(*t)
    assert wkv.launches == n0               # CPU: plain version only
    assert y.dtype == s.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, N) and tuple(s.shape) == (B, H, N, N)
    y_o, s_o = port_wkv_ref(*t)
    y_p, s_p = jax_wkv(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    y_j, s_j = _jax_wkv_ref(*args)
    for got_y, got_s in ((y, s), (y_o, s_o)):
        for want_y, want_s in ((y_p, s_p), (y_j, s_j)):
            assert _rel(got_y, want_y) < 1e-5
            assert _rel(got_s, want_s) < 1e-5
    # the one-token step of the decode path is the same recurrence
    if S == 1:
        y1, s1 = wkv_step(*(x[:, 0] for x in t[:4]), t[4], t[5])
        assert _rel(y1, y_j[:, 0]) < 1e-5 and _rel(s1, s_j) < 1e-5


def test_wkv_strong_decay_stays_finite():
    """logw = -12 in every channel (near-total decay per token): both plain
    versions stay finite and agree with the JAX oracle, as
    ``test_wkv_strong_decay_stability`` asks of the Pallas kernel."""
    args = _wkv_inputs(1, 128, 2, 32, seed=5, strong_decay=True)
    t = [_t(a) for a in args]
    y_j, s_j = _jax_wkv_ref(*args)
    for y, s in (wkv(*t), port_wkv_ref(*t)):
        assert torch.isfinite(y).all() and torch.isfinite(s).all()
        assert _rel(y, y_j) < 1e-5 and _rel(s, s_j) < 1e-5


def test_wkv_chunk_length_and_out_state():
    """The chunked form is exact for any chunk length, and ``out_state``
    (here the input state itself, as the decode step passes it) receives
    the final state and is what comes back."""
    args = _wkv_inputs(2, 45, 2, 32, seed=9)
    t = [_t(a) for a in args]
    y_o, s_o = port_wkv_ref(*t)
    for chunk in (1, 7, 45, 64):
        y, s = wkv_chunked(*t, chunk=chunk)
        assert _rel(y, y_o) < 1e-5 and _rel(s, s_o) < 1e-5
    state = t[5].clone()
    y, s = wkv(*t[:5], state, out_state=state)
    assert s is state and _rel(state, s_o) < 1e-5 and _rel(y, y_o) < 1e-5


@pytest.mark.parametrize("B,S,H,N", [
    (2, 70, 2, 64),          # 4 column blocks of 16 per head
    (1, 33, 4, 32),          # 2 column blocks
    (3, 1, 2, 64),           # the decode step's shape
])
def test_wkv_column_blocks_are_independent(B, S, H, N):
    """What the kernel's grid rests on: column j of y and of the state
    depends only on column j of v and of state0. ``wkv_ref`` on a block
    of 16 columns of v and state0 gives those columns of the full y and
    state (float32, the same operations on the same values, so within
    1e-6 of the output's scale); and each block matches the JAX package's
    Pallas ``wkv_kernel`` in interpret mode within its test's 1e-5."""
    args = _wkv_inputs(B, S, H, N, seed=7 * S + N)
    t = [_t(a) for a in args]
    y, s = port_wkv_ref(*t)
    y_p, s_p = jax_wkv(*map(jnp.asarray, args), chunk=min(S, 32),
                       interpret=True)
    y_p, s_p = np.asarray(y_p), np.asarray(s_p)
    for j0 in range(0, N, 16):
        cols = slice(j0, j0 + 16)
        y_c, s_c = port_wkv_ref(t[0], t[1], t[2][..., cols].contiguous(),
                                t[3], t[4], t[5][..., cols].contiguous())
        assert _rel(y_c, y[..., cols]) < 1e-6
        assert _rel(s_c, s[..., cols]) < 1e-6
        assert _rel(y_c, y_p[..., cols]) < 1e-5
        assert _rel(s_c, s_p[..., cols]) < 1e-5


def test_wkv_wrapper_checks_shapes():
    r = torch.zeros((1, 4, 2, 32))
    u, s0 = torch.zeros((2, 32)), torch.zeros((1, 2, 32, 32))
    with pytest.raises(ValueError, match="u"):
        wkv(r, r, r, r, torch.zeros((2, 16)), s0)
    with pytest.raises(ValueError, match="state0"):
        wkv(r, r, r, r, u, torch.zeros((1, 2, 32, 16)))
    with pytest.raises(ValueError, match="logw"):
        wkv(r, r, r, torch.zeros((1, 5, 2, 32)), u, s0)
    with pytest.raises(ValueError, match="out_state"):
        wkv(r, r, r, r, u, s0, out_state=torch.zeros((2, 2, 32, 32)))
