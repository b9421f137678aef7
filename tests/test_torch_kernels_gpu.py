"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions, on the same bf16 inputs. Marked ``gpu``: each test asks the
``cuda`` fixture for the card and skips where there is none. The file
imports torch only (the parity files beside it hold the port against the
JAX package on the CPU), so on a machine with a card and no jax it runs as

  PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_paged, decode_attention_paged_plain,
    pages_per_split, split_tokens)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rwkv6.ops import wkv
from repro_torch.kernels.rwkv6.ref import wkv_chunked, wkv_ref

pytestmark = pytest.mark.gpu

# bf16 outputs (2^-8 relative) and p rounded to bf16 inside the kernels:
# the bound the JAX package's bf16 kernel tests use
ATOL = 2e-2
# the WKV kernel and its oracle both compute in fp32 from the same inputs
# and differ only in summation order (and fused multiply-adds): relative
# to the output's scale, ten times the CPU parity bound of 1e-5
WKV_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bf16(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev).to(torch.bfloat16)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,causal,off", [
    (2, 128, 128, 4, 2, True, 0),
    (1, 256, 256, 4, 4, True, 0),
    (2, 64, 192, 2, 1, True, 128),      # chunked-prefill offset
    (1, 128, 128, 8, 2, False, 0),
    (1, 509, 509, 16, 2, True, 0),      # ragged: no multiple of the tile
    (1, 1, 1, 16, 2, True, 0),
    (1, 70, 300, 16, 2, True, 230),     # ragged offset chunk
    (1, 16, 64, 16, 2, True, 48),       # chunked prefill: Sq < 64, and
    (1, 16, 464, 16, 2, True, 448),     # q_offset not a multiple of 64
    (1, 64, 112, 16, 2, True, 48),
    (1, 64, 512, 16, 2, True, 448),
    # GQA row packing: every group size the kernel takes, Sq no multiple
    # of the 64/G positions of a tile, q_offset no multiple of the tile
    (1, 200, 200, 4, 4, True, 0),       # G = 1
    (2, 97, 130, 8, 4, True, 33),       # G = 2
    (1, 45, 300, 8, 2, True, 255),      # G = 4
    (2, 77, 77, 16, 2, True, 0),        # G = 8, B = 2, ragged Skv
    (1, 83, 200, 32, 2, True, 117),     # G = 16
    (2, 130, 70, 16, 2, False, 0),      # non-causal, ragged both ways
    (1, 1, 449, 16, 2, True, 448),      # chunk shapes Sq = 1, 16, 64
    (1, 16, 96, 16, 2, True, 80),
    (1, 64, 1000, 16, 2, True, 936),
    # long prompts: hundreds of CTAs, two per SM, many K/V tiles each
    (2, 1100, 1100, 16, 2, True, 0),    # G = 8, ragged
    (1, 3000, 3077, 32, 2, True, 77),   # G = 16 at an offset
    (4, 1100, 1100, 8, 8, True, 0),     # G = 1
    (2, 1500, 1300, 16, 2, False, 0),   # non-causal
])
def test_flash_kernel_matches_plain(cuda, B, Sq, Skv, H, Hkv, causal, off):
    rng = np.random.default_rng(3)
    q = _bf16(rng, (B, Sq, H, 128), cuda)
    k = _bf16(rng, (B, Skv, Hkv, 128), cuda)
    v = _bf16(rng, (B, Skv, Hkv, 128), cuda)
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    ref = flash_attention_ref(q, k, v, causal=causal, q_offset=off)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= ATOL


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_never_reads_the_next_sequence(cuda, causal):
    """B = 2 with Skv no multiple of the 64-key tile: the tile past Skv is
    zero-filled by TMA, not read from sequence 1. Sequence 1's K/V are
    NaN, so a single row read across the boundary would show in
    sequence 0's output."""
    rng = np.random.default_rng(29)
    Skv = 100
    q = _bf16(rng, (2, Skv, 16, 128), cuda)
    k = _bf16(rng, (2, Skv, 2, 128), cuda)
    v = _bf16(rng, (2, Skv, 2, 128), cuda)
    k[1], v[1] = float("nan"), float("nan")
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q[:1], k[:1], v[:1], causal=causal)
    assert torch.isfinite(out[0]).all()
    assert (out[:1].float() - ref.float()).abs().max().item() <= ATOL


# the 14B configurations' heads: qwen3-14b 40/8 (G = 5, no divisor of the
# 64-row tile: 12 positions fill 60 rows) and phi3-medium-14b 40/10 (G = 4
# over 10 KV heads)
HEADS_14B = [(40, 8), (40, 10)]


@pytest.mark.parametrize("H,Hkv", HEADS_14B)
@pytest.mark.parametrize("B,Sq,Skv,causal,off", [
    (1, 512, 512, True, 0),             # the serve's prefill
    (1, 509, 509, True, 0),             # ragged: no multiple of a tile
    (2, 70, 300, True, 230),            # ragged chunk at an offset, B = 2
    (1, 1, 449, True, 448),             # chunk shapes Sq = 1, 16, 64
    (1, 16, 464, True, 448),
    (1, 64, 112, True, 48),
    (1, 64, 576, True, 512),
    (1, 1100, 1177, True, 77),          # long: many K/V tiles per CTA
    (2, 130, 70, False, 0),             # non-causal, ragged both ways
])
def test_flash_kernel_at_the_14b_heads(cuda, H, Hkv, B, Sq, Skv, causal,
                                       off):
    """Flash at qwen3-14b's and phi3-medium-14b's head geometry against its
    plain version; at G = 5 the four dead rows of each tile must neither
    disturb a live row nor be written (positions p0 + 12 belong to the
    next tile)."""
    rng = np.random.default_rng(47)
    q = _bf16(rng, (B, Sq, H, 128), cuda)
    k = _bf16(rng, (B, Skv, Hkv, 128), cuda)
    v = _bf16(rng, (B, Skv, Hkv, 128), cuda)
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    ref = flash_attention_ref(q, k, v, causal=causal, q_offset=off)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= ATOL


@pytest.mark.parametrize("G", [3, 5, 6, 7, 9, 11, 12, 13, 15])
def test_flash_kernel_packs_every_group_size(cuda, G):
    """Every G up to 16 that divides no 64-row tile: B = 2, Sq no multiple
    of the floor(64/G) positions of a tile, q_offset no multiple of the
    tile; the dead rows of each tile reach no output."""
    rng = np.random.default_rng(53 + G)
    B, Sq, Skv, Hkv, off = 2, 67, 150, 2, 83
    q = _bf16(rng, (B, Sq, G * Hkv, 128), cuda)
    k = _bf16(rng, (B, Skv, Hkv, 128), cuda)
    v = _bf16(rng, (B, Skv, Hkv, 128), cuda)
    out = flash_attention(q, k, v, causal=True, q_offset=off)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, causal=True, q_offset=off)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= ATOL


def test_flash_kernel_refuses_group_sizes_it_does_not_pack(cuda):
    """The kernel packs up to 16 heads per KV head into its 64-row tiles,
    and takes dh = 64 and 128 only."""
    k = torch.zeros((1, 8, 2, 128), device=cuda, dtype=torch.bfloat16)
    q17 = torch.zeros((1, 8, 34, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                          # G = 17
        flash_attention(q17, k, k)
    q32 = torch.zeros((1, 8, 64, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                          # G = 32
        flash_attention(q32, k, k)
    q96 = torch.zeros((1, 8, 8, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                          # dh = 96
        flash_attention(q96, q96[:, :, :2], q96[:, :, :2])


def _paged_case(rng, B, N, Bs, Hkv, lengths, dev, nb=None, dh=128):
    """Pool + sequential per-sequence tables of ``nb`` columns (default:
    as many as the longest needs); pad columns -> trash block 0 (the
    layout of tests/test_kernels.py)."""
    pool_k = _bf16(rng, (N, Bs, Hkv, dh), dev)
    pool_v = _bf16(rng, (N, Bs, Hkv, dh), dev)
    nb = nb or max(-(-int(n) // Bs) for n in lengths)
    tables = np.zeros((B, nb), np.int32)
    ids = iter(range(1, N))
    for b, n in enumerate(lengths):
        for j in range(-(-int(n) // Bs)):
            tables[b, j] = next(ids)
    return (pool_k, pool_v, torch.from_numpy(tables).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("B,H,Hkv,Bs,N,lengths", [
    (2, 8, 2, 16, 32, (37, 16)),
    (3, 4, 4, 32, 16, (64, 1, 90)),
    (1, 16, 1, 8, 64, (100,)),
    (2, 8, 8, 64, 8, (64, 128)),
    (8, 16, 2, 8, 400, (577, 100, 1, 64, 300, 512, 9, 250)),
])
def test_paged_kernel_matches_plain(cuda, B, H, Hkv, Bs, N, lengths):
    rng = np.random.default_rng(11)
    q = _bf16(rng, (B, H, 128), cuda)
    pool_k, pool_v, tables, lens = _paged_case(rng, B, N, Bs, Hkv, lengths,
                                               cuda)
    n0 = decode_attention_paged.launches
    out = decode_attention_paged(q, pool_k, pool_v, tables, lens)
    torch.cuda.synchronize()
    assert decode_attention_paged.launches == n0 + 1
    ref = decode_attention_paged_plain(q, pool_k, pool_v, tables, lens)
    assert (out.float() - ref.float()).abs().max().item() <= ATOL


def _split_tokens(B, Hkv, nb, Bs):
    return pages_per_split(B, Hkv, nb, Bs) * Bs


@pytest.mark.parametrize("H", [8, 16, 32])              # G = 4, 8, 16
@pytest.mark.parametrize("nb", [73, 128])               # the serve's window,
def test_paged_kernel_split_edges(cuda, H, nb):         # and a wider table
    """The shape's split (32 tokens at nb = 73, 56 at nb = 128): lengths
    of 1 token, exactly one split, one token past it, several splits and
    the whole window, at G = 4, 8 and 16."""
    rng = np.random.default_rng(23)
    B, Hkv, Bs = 8, 2, 8
    T = _split_tokens(B, Hkv, nb, Bs)
    lengths = (1, T, T + 1, 2 * T - 1, 3 * T + 1, 544, 73 * 8, 9)
    q = _bf16(rng, (B, H, 128), cuda)
    pool_k, pool_v, tables, lens = _paged_case(
        rng, B, 1 + sum(-(-n // Bs) for n in lengths), Bs, Hkv, lengths,
        cuda, nb=nb)
    out = decode_attention_paged(q, pool_k, pool_v, tables, lens)
    torch.cuda.synchronize()
    ref = decode_attention_paged_plain(q, pool_k, pool_v, tables, lens)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= ATOL


@pytest.mark.parametrize("H", [8, 16, 32])
def test_paged_kernel_poisoned_blocks_at_the_serve_shape(cuda, H):
    """The trash block and every tail past a length poisoned to +-1e4 (and
    NaN in the trash block's second half) leave the output bit-unchanged
    at the serve's geometry: Bs = 8, 32-token splits, G = 4, 8, 16."""
    rng = np.random.default_rng(31)
    B, Hkv, Bs, nb = 8, 2, 8, 73
    lengths = (577, 100, 1, 64, 300, 512, 9, 33)
    q = _bf16(rng, (B, H, 128), cuda)
    pool_k, pool_v, tables, lens = _paged_case(
        rng, B, 1 + sum(-(-n // Bs) for n in lengths), Bs, Hkv, lengths,
        cuda, nb=nb)
    out1 = decode_attention_paged(q, pool_k, pool_v, tables, lens)
    pool_k2, pool_v2 = pool_k.clone(), pool_v.clone()
    pool_k2[0], pool_v2[0] = 1e4, -1e4
    pool_k2[0, 4:], pool_v2[0, 4:] = float("nan"), float("nan")
    for b, n in enumerate(lengths):
        if n % Bs:
            last = int(tables[b, (n - 1) // Bs])
            pool_k2[last, n % Bs:] = 77.0
            pool_v2[last, n % Bs:] = -77.0
    out2 = decode_attention_paged(q, pool_k2, pool_v2, tables, lens)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2)


@pytest.mark.parametrize("H,Hkv", HEADS_14B)
@pytest.mark.parametrize("nb", [73, 128])
def test_paged_kernel_at_the_14b_heads(cuda, H, Hkv, nb):
    """Paged decode at 40/8 (G = 5: Q padded to 8 rows of the MMA) and
    40/10 heads (a grid 10 KV heads wide): lengths at the edges of the
    shape's split (1, one split, one past it, several, the serve's 544,
    the whole window) against the plain version; then the trash block and
    every tail past a length poisoned (+-1e4, NaN in the trash block's
    second half) must leave the output bit-unchanged."""
    rng = np.random.default_rng(59)
    B, Bs = 8, 8
    T = _split_tokens(B, Hkv, nb, Bs)
    lengths = (1, T, T + 1, 2 * T - 1, 3 * T + 1, 544, nb * Bs, 9)
    q = _bf16(rng, (B, H, 128), cuda)
    pool_k, pool_v, tables, lens = _paged_case(
        rng, B, 1 + sum(-(-n // Bs) for n in lengths), Bs, Hkv, lengths,
        cuda, nb=nb)
    out = decode_attention_paged(q, pool_k, pool_v, tables, lens)
    torch.cuda.synchronize()
    ref = decode_attention_paged_plain(q, pool_k, pool_v, tables, lens)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= ATOL
    pool_k2, pool_v2 = pool_k.clone(), pool_v.clone()
    pool_k2[0], pool_v2[0] = 1e4, -1e4
    pool_k2[0, 4:], pool_v2[0, 4:] = float("nan"), float("nan")
    for b, n in enumerate(lengths):
        if n % Bs:
            last = int(tables[b, (n - 1) // Bs])
            pool_k2[last, n % Bs:] = 77.0
            pool_v2[last, n % Bs:] = -77.0
    out2 = decode_attention_paged(q, pool_k2, pool_v2, tables, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


def test_paged_kernel_garbage_block_immunity(cuda):
    """Trash-block contents and positions past a length must not leak:
    the kernel never reads them, so the output is bit-identical."""
    rng = np.random.default_rng(13)
    lengths = (20, 33)
    q = _bf16(rng, (2, 4, 128), cuda)
    pool_k, pool_v, tables, lens = _paged_case(rng, 2, 16, 16, 2, lengths,
                                               cuda)
    out1 = decode_attention_paged(q, pool_k, pool_v, tables, lens)
    pool_k2, pool_v2 = pool_k.clone(), pool_v.clone()
    pool_k2[0], pool_v2[0] = 1e4, -1e4
    for b, n in enumerate(lengths):
        last = int(tables[b, (n - 1) // 16])
        pool_k2[last, n % 16 or 16:] = 77.0
        pool_v2[last, n % 16 or 16:] = -77.0
    out2 = decode_attention_paged(q, pool_k2, pool_v2, tables, lens)
    assert torch.equal(out1, out2)


def _dense_case(rng, B, Smax, H, Hkv, lengths, dev, dh=128):
    return (_bf16(rng, (B, H, dh), dev), _bf16(rng, (B, Smax, Hkv, dh), dev),
            _bf16(rng, (B, Smax, Hkv, dh), dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("B,Smax,H,Hkv,lengths", [
    (8, 584, 16, 2, (1, 584, 100, 128, 129, 300, 512, 9)),   # engine shape
    (2, 256, 8, 2, (37, 256)),
    (3, 512, 4, 4, (64, 1, 90)),
    (2, 128, 16, 1, (0, 700)),          # empty row; length past Smax
])
def test_dense_kernel_matches_plain(cuda, B, Smax, H, Hkv, lengths):
    rng = np.random.default_rng(17)
    q, k, v, lens = _dense_case(rng, B, Smax, H, Hkv, lengths, cuda)
    n0 = decode_attention.launches
    out = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    ref = decode_attention_ref(q, k, v, lens)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= ATOL


def test_dense_kernel_length_mask_exact(cuda):
    """Rows at and past a length are never read: poisoning them with
    +-1e4 leaves the output bit-identical."""
    rng = np.random.default_rng(19)
    lengths = (1, 584, 40, 129, 300, 512, 9, 250)
    q, k, v, lens = _dense_case(rng, 8, 584, 16, 2, lengths, cuda)
    out1 = decode_attention(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(lengths):
        k2[b, n:], v2[b, n:] = 1e4, -1e4
    out2 = decode_attention(q, k2, v2, lens)
    assert torch.equal(out1, out2)


@pytest.mark.parametrize("H", [8, 16, 32])              # G = 4, 8, 16
@pytest.mark.parametrize("B,Smax,T", [
    (8, 584, 32),        # the dense serve's step: 19 splits, the last cut
    (12, 584, 48),
    (16, 584, 64),
    (4, 100, 32),        # fewer CTAs than the target: the shortest split
])
def test_dense_kernel_split_edges(cuda, H, B, Smax, T):
    """The shape's split (32, 48 or 64 rows; Smax no multiple of it):
    lengths 0, 1, at and around split boundaries, Smax - 1, Smax and past
    it, at G = 4, 8 and 16; then every row at or past a length poisoned
    (+-1e4, NaN in half of them) leaves the output bit-unchanged."""
    assert split_tokens(B, 2, Smax) == T
    rng = np.random.default_rng(37)
    edges = [0, 1, T - 1, T, T + 1, 2 * T, Smax - 1, Smax, Smax + 5,
             Smax - T, Smax - T + 1, 3 * T - 1, T // 2, 2 * T + 1, 5, 77]
    lengths = tuple(min(n, Smax + 5) for n in edges[:B])
    q, k, v, lens = _dense_case(rng, B, Smax, H, 2, lengths, cuda)
    out = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q, k, v, lens)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= ATOL
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(lengths):
        k2[b, n:], v2[b, n:] = 1e4, -1e4
        if b % 2:
            k2[b, n + 3:], v2[b, n + 3:] = float("nan"), float("nan")
    out2 = decode_attention(q, k2, v2, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


@pytest.mark.parametrize("H,Hkv", HEADS_14B)
@pytest.mark.parametrize("B,Smax", [(8, 584), (2, 584), (4, 100)])
def test_dense_kernel_at_the_14b_heads(cuda, H, Hkv, B, Smax):
    """Dense decode at 40/8 and 40/10 heads: lengths 0, 1, at and around
    the shape's split boundaries, Smax and past it, against the plain
    version; then every row at or past a length poisoned leaves the output
    bit-unchanged."""
    T = split_tokens(B, Hkv, Smax)
    rng = np.random.default_rng(61)
    edges = [0, 1, T - 1, T, T + 1, Smax, Smax + 5, 2 * T + 1]
    lengths = tuple(edges[:B])
    q, k, v, lens = _dense_case(rng, B, Smax, H, Hkv, lengths, cuda)
    out = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q, k, v, lens)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= ATOL
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(lengths):
        k2[b, n:], v2[b, n:] = 1e4, -1e4
    out2 = decode_attention(q, k2, v2, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


def test_dense_kernel_long_context(cuda):
    """B = 32 x Smax 4096 (64-row splits, 4,096 CTAs), full and ragged
    lengths, against the plain version."""
    rng = np.random.default_rng(41)
    B, Smax = 32, 4096
    assert split_tokens(B, 2, Smax) == 64
    lengths = tuple([4096] * 24 + [4095, 4033, 4032, 1, 64, 65, 2000, 0])
    q, k, v, lens = _dense_case(rng, B, Smax, 16, 2, lengths, cuda)
    out = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q, k, v, lens)
    assert (out.float() - ref.float()).abs().max().item() <= ATOL


def test_kernels_refuse_what_they_do_not_take(cuda):
    """On CUDA tensors the wrappers launch or raise: no plain fallback."""
    q = torch.zeros((1, 8, 4, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :2], q[:, :, :2])       # dh 96
    k96 = torch.zeros((1, 16, 2, 96), device=cuda, dtype=torch.bfloat16)
    l96 = torch.ones((1,), device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError):                          # dh 96
        decode_attention(torch.zeros((1, 4, 96), device=cuda,
                                     dtype=torch.bfloat16), k96, k96, l96)
    with pytest.raises(ValueError):                          # dh 96
        decode_attention_paged(
            torch.zeros((1, 4, 96), device=cuda, dtype=torch.bfloat16),
            k96, k96, torch.ones((1, 2), device=cuda, dtype=torch.int32),
            l96)
    q32 = torch.zeros((1, 8, 4, 128), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q32, q32[:, :, :2], q32[:, :, :2])  # fp32
    kc = torch.zeros((1, 16, 2, 128), device=cuda, dtype=torch.bfloat16)
    lens = torch.ones((1,), device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError):                          # fp32 q
        decode_attention(torch.zeros((1, 4, 128), device=cuda), kc, kc, lens)
    with pytest.raises(ValueError):                          # int64 lengths
        decode_attention(kc[:, 0, :, :].repeat(1, 2, 1), kc, kc, lens.long())


def _wkv_case(rng, B, S, H, N, dev, in_dtype=torch.bfloat16, logw=None):
    """r, k, v in ``in_dtype``; data-dependent fp32 logw <= 0 (or the given
    constant); fp32 u and a nonzero fp32 state."""
    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev)
    r, k, v = (f32(B, S, H, N).to(in_dtype) for _ in range(3))
    lw = (-torch.exp(f32(B, S, H, N) - 0.5) if logw is None
          else torch.full((B, S, H, N), float(logw), device=dev))
    return r, k, v, lw, f32(H, N, scale=0.5), f32(B, H, N, N, scale=0.1)


def _wkv_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1.0)).item()


@pytest.mark.parametrize("B,S,H,N,in_dtype", [
    (1, 512, 32, 64, torch.bfloat16),   # rwkv6-1.6b prefill
    (8, 1, 32, 64, torch.bfloat16),     # rwkv6-1.6b decode step, 8 slots
    (1, 500, 32, 64, torch.bfloat16),   # ragged: no multiple of the tile
    (2, 128, 2, 64, torch.float32),     # tests/test_kernels.py shapes
    (1, 96, 4, 32, torch.float32),
    (1, 160, 2, 64, torch.float32),
    (3, 33, 4, 32, torch.bfloat16),
])
def test_wkv_kernel_matches_ref(cuda, B, S, H, N, in_dtype):
    rng = np.random.default_rng(23)
    r, k, v, lw, u, s0 = _wkv_case(rng, B, S, H, N, cuda, in_dtype)
    n0 = wkv.launches
    y, s = wkv(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert wkv.launches == n0 + 1
    assert y.dtype == s.dtype == torch.float32 and y.shape == r.shape
    y_r, s_r = wkv_ref(r, k, v, lw, u, s0)
    assert _wkv_err(y, y_r) <= WKV_RTOL and _wkv_err(s, s_r) <= WKV_RTOL
    y_c, s_c = wkv_chunked(r, k, v, lw, u, s0)      # the plain model path
    assert _wkv_err(y, y_c) <= WKV_RTOL and _wkv_err(s, s_c) <= WKV_RTOL


@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,H", [(32, 4), (64, 32)])
@pytest.mark.parametrize("B,S", [(1, 1), (1, 500), (1, 512), (8, 1),
                                 (8, 33)])
def test_wkv_kernel_column_blocks(cuda, B, S, N, H, in_dtype):
    """Every column block of the state (N / 16 of them per head) at the
    decode shape (S = 1), a ragged S (no multiple of the 32-token tile)
    and the prefill's S = 512, B = 1 and 8, bf16 and fp32 inputs, against
    the sequential oracle; then in place (``out_state=state0``), which
    must give the out-of-place result bit for bit."""
    rng = np.random.default_rng(43 + S + N)
    r, k, v, lw, u, s0 = _wkv_case(rng, B, S, H, N, cuda, in_dtype)
    y, s = wkv(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    y_r, s_r = wkv_ref(r, k, v, lw, u, s0)
    assert _wkv_err(y, y_r) <= WKV_RTOL and _wkv_err(s, s_r) <= WKV_RTOL
    state = s0.clone()
    y2, s2 = wkv(r, k, v, lw, u, state, out_state=state)
    torch.cuda.synchronize()
    assert s2 is state and torch.equal(state, s) and torch.equal(y2, y)


def test_wkv_kernel_in_place_and_strong_decay(cuda):
    """``out_state=state0`` overwrites the state in place with the same
    result; near-total decay (logw = -12) stays finite and right."""
    rng = np.random.default_rng(29)
    r, k, v, lw, u, s0 = _wkv_case(rng, 8, 1, 32, 64, cuda)
    y_r, s_r = wkv_ref(r, k, v, lw, u, s0)
    state = s0.clone()
    y, s = wkv(r, k, v, lw, u, state, out_state=state)
    torch.cuda.synchronize()
    assert s is state
    assert _wkv_err(y, y_r) <= WKV_RTOL and _wkv_err(state, s_r) <= WKV_RTOL
    r, k, v, lw, u, s0 = _wkv_case(rng, 1, 128, 2, 32, cuda, logw=-12.0)
    y, s = wkv(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y_r, s_r = wkv_ref(r, k, v, lw, u, s0)
    assert _wkv_err(y, y_r) <= WKV_RTOL and _wkv_err(s, s_r) <= WKV_RTOL


def test_wkv_kernel_refuses_what_it_does_not_take(cuda):
    rng = np.random.default_rng(31)
    r, k, v, lw, u, s0 = _wkv_case(rng, 1, 4, 2, 64, cuda)
    with pytest.raises(ValueError):                          # head size 16
        wkv(*(a[..., :16] for a in (r, k, v, lw)), u[:, :16],
            s0[:, :, :16, :16].contiguous())
    with pytest.raises(ValueError):                          # fp16 inputs
        wkv(r.half(), k.half(), v.half(), lw, u, s0)
    with pytest.raises(ValueError):                          # bf16 logw
        wkv(r, k, v, lw.bfloat16(), u, s0)
    with pytest.raises(ValueError):                          # not contiguous
        wkv(r, k, v, lw, u, s0.transpose(2, 3))
    with pytest.raises(ValueError):                          # CPU state
        wkv(r, k, v, lw, u, s0.cpu())


# ---------------------------------------------------------------------------
# head dim 64: granite-moe-1b-a400m's 16 query / 8 KV heads of 64 (G = 2),
# and every group size up to 16 at dh = 64

GRANITE = (16, 8)


@pytest.mark.parametrize("B,Sq,Skv,causal,off", [
    (1, 512, 512, True, 0),             # the serve's prefill
    (1, 509, 509, True, 0),             # ragged: no multiple of a tile
    (2, 70, 300, True, 230),            # ragged chunk at an offset, B = 2
    (1, 1, 449, True, 448),             # chunk shapes Sq = 1, 16, 64
    (1, 16, 464, True, 448),
    (1, 64, 112, True, 48),
    (1, 64, 576, True, 512),
    (1, 1100, 1177, True, 77),          # long: many K/V tiles per CTA
    (2, 130, 70, False, 0),             # non-causal, ragged both ways
    (2, 1500, 1300, False, 0),
])
def test_flash_kernel_at_dh64_granite_heads(cuda, B, Sq, Skv, causal, off):
    """Flash at dh = 64 (one 64-column box per tile, P V on m64n64k16) at
    granite's heads against its plain version."""
    H, Hkv = GRANITE
    rng = np.random.default_rng(67)
    q = _bf16(rng, (B, Sq, H, 64), cuda)
    k = _bf16(rng, (B, Skv, Hkv, 64), cuda)
    v = _bf16(rng, (B, Skv, Hkv, 64), cuda)
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    ref = flash_attention_ref(q, k, v, causal=causal, q_offset=off)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= ATOL


@pytest.mark.parametrize("G", list(range(1, 17)))
def test_flash_kernel_at_dh64_every_group_size(cuda, G):
    """Every G from 1 to 16 at dh = 64: B = 2, Sq no multiple of the
    floor(64/G) positions of a tile, q_offset no multiple of the tile; the
    dead rows of a tile reach no output (the epilogue's 8-chunk rows walk
    16 rows per pass)."""
    rng = np.random.default_rng(71 + G)
    B, Sq, Skv, Hkv, off = 2, 67, 150, 2, 83
    q = _bf16(rng, (B, Sq, G * Hkv, 64), cuda)
    k = _bf16(rng, (B, Skv, Hkv, 64), cuda)
    v = _bf16(rng, (B, Skv, Hkv, 64), cuda)
    out = flash_attention(q, k, v, causal=True, q_offset=off)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, causal=True, q_offset=off)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= ATOL


def test_flash_kernel_at_dh64_never_reads_the_next_sequence(cuda):
    """dh = 64, B = 2, Skv no multiple of the 64-key tile: sequence 1's K/V
    are NaN and sequence 0's output stays finite and right."""
    rng = np.random.default_rng(73)
    q = _bf16(rng, (2, 100, 16, 64), cuda)
    k = _bf16(rng, (2, 100, 8, 64), cuda)
    v = _bf16(rng, (2, 100, 8, 64), cuda)
    k[1], v[1] = float("nan"), float("nan")
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q[:1], k[:1], v[:1], causal=True)
    assert torch.isfinite(out[0]).all()
    assert (out[:1].float() - ref.float()).abs().max().item() <= ATOL


def _poison_paged(pool_k, pool_v, tables, lengths, Bs):
    """The trash block (+-1e4, NaN in its second half) and every tail past
    a length (+-77) poisoned, on copies."""
    pool_k2, pool_v2 = pool_k.clone(), pool_v.clone()
    pool_k2[0], pool_v2[0] = 1e4, -1e4
    pool_k2[0, Bs // 2:], pool_v2[0, Bs // 2:] = float("nan"), float("nan")
    for b, n in enumerate(lengths):
        if n % Bs:
            last = int(tables[b, (n - 1) // Bs])
            pool_k2[last, n % Bs:] = 77.0
            pool_v2[last, n % Bs:] = -77.0
    return pool_k2, pool_v2


@pytest.mark.parametrize("nb", [73, 128])
def test_paged_kernel_at_dh64_granite_heads(cuda, nb):
    """Paged decode at dh = 64 and granite's heads (G = 2: Q padded to the
    MMA's 8 rows; 4 warps x 16 columns of O^T): lengths at the edges of the
    shape's split, the serve's 544 and the whole window, against the plain
    version; then the trash block and every tail past a length poisoned
    must leave the output bit-unchanged."""
    H, Hkv = GRANITE
    rng = np.random.default_rng(79)
    B, Bs = 8, 8
    T = _split_tokens(B, Hkv, nb, Bs)
    lengths = (1, T, T + 1, 2 * T - 1, 3 * T + 1, 544, nb * Bs, 9)
    q = _bf16(rng, (B, H, 64), cuda)
    pool_k, pool_v, tables, lens = _paged_case(
        rng, B, 1 + sum(-(-n // Bs) for n in lengths), Bs, Hkv, lengths,
        cuda, nb=nb, dh=64)
    n0 = decode_attention_paged.launches
    out = decode_attention_paged(q, pool_k, pool_v, tables, lens)
    torch.cuda.synchronize()
    assert decode_attention_paged.launches == n0 + 1
    ref = decode_attention_paged_plain(q, pool_k, pool_v, tables, lens)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= ATOL
    pk2, pv2 = _poison_paged(pool_k, pool_v, tables, lengths, Bs)
    out2 = decode_attention_paged(q, pk2, pv2, tables, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


@pytest.mark.parametrize("G", list(range(1, 17)))
def test_paged_kernel_at_dh64_every_group_size(cuda, G):
    """Every G from 1 to 16 at dh = 64 (one or two n-tiles of heads, zero
    rows padding G to 8), mixed lengths over 2 KV heads, against the plain
    version."""
    rng = np.random.default_rng(83 + G)
    B, Hkv, Bs = 8, 2, 8
    lengths = (577, 100, 1, 64, 300, 512, 9, 250)
    q = _bf16(rng, (B, G * Hkv, 64), cuda)
    pool_k, pool_v, tables, lens = _paged_case(
        rng, B, 1 + sum(-(-n // Bs) for n in lengths), Bs, Hkv, lengths,
        cuda, dh=64)
    out = decode_attention_paged(q, pool_k, pool_v, tables, lens)
    torch.cuda.synchronize()
    ref = decode_attention_paged_plain(q, pool_k, pool_v, tables, lens)
    assert (out.float() - ref.float()).abs().max().item() <= ATOL
    pk2, pv2 = _poison_paged(pool_k, pool_v, tables, lengths, Bs)
    out2 = decode_attention_paged(q, pk2, pv2, tables, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


@pytest.mark.parametrize("B,Smax", [(8, 584), (2, 584), (12, 584), (4, 100)])
def test_dense_kernel_at_dh64_granite_heads(cuda, B, Smax):
    """Dense decode at dh = 64 and granite's heads: lengths 0, 1, at and
    around the shape's split boundaries, Smax and past it, against the
    plain version; then every row at or past a length poisoned (+-1e4,
    NaN in half of them) leaves the output bit-unchanged."""
    H, Hkv = GRANITE
    T = split_tokens(B, Hkv, Smax)
    rng = np.random.default_rng(89)
    edges = [0, 1, T - 1, T, T + 1, 2 * T, Smax - 1, Smax, Smax + 5,
             Smax - T, Smax - T + 1, 2 * T + 1]
    lengths = tuple(edges[:B])
    q, k, v, lens = _dense_case(rng, B, Smax, H, Hkv, lengths, cuda, dh=64)
    n0 = decode_attention.launches
    out = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    ref = decode_attention_ref(q, k, v, lens)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= ATOL
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(lengths):
        k2[b, n:], v2[b, n:] = 1e4, -1e4
        if b % 2:
            k2[b, n + 3:], v2[b, n + 3:] = float("nan"), float("nan")
    out2 = decode_attention(q, k2, v2, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


@pytest.mark.parametrize("G", [1, 2, 5, 8, 16])
def test_dense_kernel_at_dh64_group_sizes(cuda, G):
    """Dense decode at dh = 64 over G = 1 to 16 heads per KV head, the
    dense serve's cache (584 rows, no multiple of the split)."""
    rng = np.random.default_rng(97 + G)
    lengths = (1, 584, 100, 128, 129, 300, 512, 9)
    q, k, v, lens = _dense_case(rng, 8, 584, 2 * G, 2, lengths, cuda, dh=64)
    out = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q, k, v, lens)
    assert (out.float() - ref.float()).abs().max().item() <= ATOL
