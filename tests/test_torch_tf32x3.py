"""The f32 route's tensor-core arithmetic, emulated on the CPU.

On the card, the f32 route's K3 (``csrc/attention.cu``), K4 and K5
(``csrc/attention_bwd.cu``) multiply by the 3xTF32 split of
``csrc/tf32x3.cuh``: every f32 operand x becomes big = x rounded to TF32
(10 mantissa bits, to nearest, ties away from zero: ``cvt.rna.tf32.f32``)
and small = x - big truncated to TF32, and a product a b is
a_big b_small + a_small b_big + a_big b_big, small terms first, in f32.
The tests run without a card, so the kernels' arithmetic is emulated
here in plain torch (rounding and truncation on the float32 bits, each
TF32 term a float32 product, whose 11-bit by 11-bit products are exact)
and held, tile by tile (``tile_rel_err``), to the plain versions the card
holds the kernels to, ``flash_attention_reference``,
``flash_backward_dq_reference`` and ``flash_backward_dkv_reference``, at
the route's limit of 1e-5. One TF32
term alone must miss that limit, so the card's check can tell a kernel
that forgot the split.

The tensor cores also truncate each mma's sum where f32 rounds it. A model
of that (each m16n8k8 step's result cut to 24 significant bits toward
zero) shows why the kernels start P v (K3) and dS k (K4) from zero every
key tile: one chain over 2,048 keys misses the limit, the kernels' chains
hold it.
"""

import math

import numpy as np
import pytest
import torch

from nvshare_tpu_torch.ops import attention as tatt
from nvshare_tpu_torch.parallel.dryrun import tile_rel_err

LIMIT = 1e-5   # the f32 route's tile-wise limit (chip_smoke.K3_TILE_REL)
SHAPES = {"b2_s256_h2_d64": (2, 256, 2, 64),
          "b1_s1024_h2_d128": (1, 1024, 2, 128)}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """The kernels' ``to_tf32`` on float32 ``x``, cvt.rna.tf32.f32 for a
    finite x: add half of the 13 dropped bits' unit to the magnitude bits
    and clear them (ties away from zero). The card's NaN, 0x7fffffff,
    carries into the sign: -0.0."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000          # unsigned 32-bit pattern
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with its 13 low bits cleared (NaN stays NaN)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    """The kernels' split: big rounded, small = x - big truncated, which
    keeps a NaN x's NaN whatever big is."""
    big = tf32(x)
    return big, tf32_truncated(x - big)


def product(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b (float32, batched) as the kernels form it: three TF32 terms,
    the small ones first, summed in f32; or one TF32 term."""
    ab, asm = split(a)
    bb, bsm = split(b)
    if terms == 1:
        return ab @ bb
    return (ab @ bsm + asm @ bb) + ab @ bb


def heads_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 1, 3).float()       # [B, S, H, D] -> [B, H, S, D]


def rows_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 1, 3)               # back to [B, S, H, D]


def inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    b, s, h, d = shape
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                    * 0.5) for _ in range(4))
    g_lse = torch.from_numpy(rng.randn(b * h, s).astype(np.float32) * 0.5)
    return q, k, v, do, g_lse


def causal_mask(s: int) -> torch.Tensor:
    return torch.arange(s)[:, None] < torch.arange(s)[None, :]


def emulated_forward(q, k, v, causal: bool, terms: int) -> torch.Tensor:
    """K3's products by the split, its softmax in f32: out [B, S, H, D]."""
    qh, kh, vh = heads_first(q), heads_first(k), heads_first(v)
    s = product(qh, kh.transpose(-1, -2), terms) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        s = s.masked_fill(causal_mask(q.shape[1]), -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return rows_last(product(p, vh, terms) / p.sum(dim=-1, keepdim=True))


def emulated_dkv(q, k, v, do, lse, delta, g_lse, causal: bool, terms: int):
    """K5's four products by the split, p and dS in f32: (dK, dV)."""
    b, s, h, d = q.shape
    qh, kh, vh, dh = (heads_first(x) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    rows = (lse.reshape(b, h, 1, s), (delta - g_lse).reshape(b, h, 1, s))
    st = product(kh, qh.transpose(-1, -2), terms)          # [B, H, keys, q]
    dpt = product(vh, dh.transpose(-1, -2), terms)
    pt = torch.exp(st * scale - rows[0])
    if causal:
        pt = pt.masked_fill(causal_mask(s).T, 0.0)
    dst = pt * (dpt - rows[1]) * scale
    return (rows_last(product(dst, qh, terms)),
            rows_last(product(pt, dh, terms)))


K4_KEYS = 32   # K4's keys per ring stage: dS k runs from zero over each


def emulated_dq(q, k, v, do, lse, delta, g_lse, causal: bool, terms: int):
    """K4's three products by the split, in the kernel's order: s = q k^T
    and dP = dO v^T one product over D each, p and dS in f32, then dS k
    from zero over each K4_KEYS-key stage, the stages added in f32 in key
    order. dQ [B, S, H, D]."""
    b, s, h, d = q.shape
    qh, kh, vh, dh = (heads_first(x) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    rows = (lse.reshape(b, h, s, 1), (delta - g_lse).reshape(b, h, s, 1))
    st = product(qh, kh.transpose(-1, -2), terms)          # [B, H, q, keys]
    dp = product(dh, vh.transpose(-1, -2), terms)
    p = torch.exp(st * scale - rows[0])
    if causal:
        p = p.masked_fill(causal_mask(s), 0.0)
    ds = p * (dp - rows[1]) * scale
    dq = torch.zeros_like(qh)
    for k0 in range(0, kh.shape[2], K4_KEYS):
        keys = slice(k0, k0 + K4_KEYS)
        dq = dq + product(ds[..., keys], kh[:, :, keys], terms)
    return rows_last(dq)


def test_rounding_is_to_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10                            # TF32's unit at 1.0
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -20,
                      1 + 1.5 * ulp, 3.0, float("inf"), -float("inf"),
                      2.0 ** -130], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0,
                         float("inf"), -float("inf"), 2.0 ** -130],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    # NaN: the card's own (0x7fffffff), the quiet one PyTorch writes
    # (0x7fc00000) and a negative one. Rounding carries the card's into
    # the sign, but the split's small half keeps every NaN, so a NaN
    # operand makes its products NaN, as in f32.
    nans = torch.tensor([0x7FFFFFFF, 0x7FC00000, -1],
                        dtype=torch.int32).view(torch.float32)
    assert tf32(nans)[0].item() == 0.0 and torch.isnan(tf32(nans)[1])
    assert torch.isnan(split(nans)[1]).all()
    a = torch.ones((4, 8))
    a[2, 5] = nans[0]
    got = product(a, torch.ones((8, 3)), terms=3)
    assert torch.isnan(got[2]).all() and not torch.isnan(got[[0, 1, 3]]).any()
    # Every result has 10 mantissa bits, and the split is exact to 2^-21
    # (small's truncation).
    y = torch.from_numpy(np.random.RandomState(1).randn(4096)
                         .astype(np.float32))
    big, small = split(y)
    assert not ((big.view(torch.int32) & 0x1FFF) != 0).any()
    assert not ((small.view(torch.int32) & 0x1FFF) != 0).any()
    assert ((big.double() + small.double() - y.double()).abs()
            <= 2.0 ** -21 * y.double().abs()).all()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_holds_k3_products_and_one_term_does_not(shape, causal):
    q, k, v, _, _ = inputs(SHAPES[shape])
    want, _ = tatt.flash_attention_reference(q, k, v, causal=causal)
    three = tile_rel_err(emulated_forward(q, k, v, causal, 3), want)
    one = tile_rel_err(emulated_forward(q, k, v, causal, 1), want)
    assert three <= LIMIT, three
    assert one > LIMIT, one


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_holds_k5_products_and_one_term_does_not(shape, causal):
    q, k, v, do, g_lse = inputs(SHAPES[shape])
    o, lse = tatt.flash_attention_reference(q, k, v, causal=causal)
    delta = tatt.attention_delta(o, do)
    want = tatt.flash_backward_dkv_reference(q, k, v, do, lse, delta,
                                             causal, g_lse)
    for terms in (3, 1):
        got = emulated_dkv(q, k, v, do, lse, delta, g_lse, causal, terms)
        errs = [tile_rel_err(g, w) for g, w in zip(got, want)]
        if terms == 3:
            assert max(errs) <= LIMIT, errs
        else:
            assert min(errs) > LIMIT, errs


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_holds_k4_products_and_one_term_does_not(shape, causal):
    q, k, v, do, g_lse = inputs(SHAPES[shape])
    o, lse = tatt.flash_attention_reference(q, k, v, causal=causal)
    delta = tatt.attention_delta(o, do)
    want = tatt.flash_backward_dq_reference(q, k, v, do, lse, delta,
                                            causal, g_lse)
    three = tile_rel_err(
        emulated_dq(q, k, v, do, lse, delta, g_lse, causal, 3), want)
    one = tile_rel_err(
        emulated_dq(q, k, v, do, lse, delta, g_lse, causal, 1), want)
    assert three <= LIMIT, three
    assert one > LIMIT, one


def truncate(x: torch.Tensor) -> torch.Tensor:
    """x (float64) cut to 24 significant bits toward zero: the model of an
    mma's sum."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.trunc(m * 2.0 ** 24) / 2.0 ** 24, e)


def mma_chain(c: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """c + a @ b as a chain of m16n8k8 mma.sync steps over k, three split
    terms a step, each step's result truncated."""
    (ab, asm), (bb, bsm) = split(a), split(b)
    c = c.double()
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((ab, bsm), (asm, bb), (ab, bb)):
            c = truncate(c + x[..., ks].double() @ y[..., ks, :].double())
    return c.float()


def truncated_forward(q, k, v, chain_keys: bool) -> torch.Tensor:
    """K3 over 64-key tiles (causal, online softmax in f32) with every
    product an mma chain; P v chained over all keys, or from zero a tile
    and added in f32 as the kernel does."""
    qh, kh, vh = heads_first(q), heads_first(k), heads_first(v)
    b, h, s, d = qh.shape
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, 64):
        kt, vt = kh[:, :, k0:k0 + 64], vh[:, :, k0:k0 + 64]
        st = mma_chain(torch.zeros((b, h, s, 64)), qh, kt.transpose(-1, -2))
        st = (st * (1.0 / math.sqrt(d))).masked_fill(
            rows < torch.arange(k0, k0 + 64)[None, :], -1e30)
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        m, l, acc = m_new, l * corr + p.sum(dim=-1, keepdim=True), acc * corr
        if chain_keys:
            acc = mma_chain(acc, p, vt)
        else:
            acc = acc + mma_chain(torch.zeros_like(acc), p, vt)
    return rows_last(acc / l)


def test_truncating_sums_need_the_kernels_short_chains():
    # 2,048 keys: 768 truncated steps in one chain (the card read 1.7e-5
    # for K3 at [4, 2048, 32, 128] with P v chained over every key).
    q, k, v, _, _ = inputs((1, 2048, 1, 64), seed=2)
    want, _ = tatt.flash_attention_reference(q, k, v, causal=True)
    one_chain = tile_rel_err(truncated_forward(q, k, v, True), want)
    per_tile = tile_rel_err(truncated_forward(q, k, v, False), want)
    assert one_chain > LIMIT, one_chain
    assert per_tile <= LIMIT / 5, per_tile


def truncated_dq(q, k, v, do, lse, delta, g_lse,
                 chain_keys: bool) -> torch.Tensor:
    """K4 (causal) with every product an mma chain: s and dP over D, then
    dS k chained over all keys, or from zero a K4_KEYS-key stage and added
    in f32 as the kernel does."""
    qh, kh, vh, dh = (heads_first(x) for x in (q, k, v, do))
    b, h, s, d = qh.shape
    scale = 1.0 / math.sqrt(d)
    st = mma_chain(torch.zeros((b, h, s, s)), qh, kh.transpose(-1, -2))
    dp = mma_chain(torch.zeros((b, h, s, s)), dh, vh.transpose(-1, -2))
    p = torch.exp(st * scale - lse.reshape(b, h, s, 1))
    p = p.masked_fill(causal_mask(s), 0.0)
    ds = p * (dp - (delta - g_lse).reshape(b, h, s, 1)) * scale
    if chain_keys:
        return rows_last(mma_chain(torch.zeros_like(qh), ds, kh))
    dq = torch.zeros_like(qh)
    for k0 in range(0, s, K4_KEYS):
        keys = slice(k0, k0 + K4_KEYS)
        dq = dq + mma_chain(torch.zeros_like(qh), ds[..., keys],
                            kh[:, :, keys])
    return rows_last(dq)


def test_truncating_dq_sums_need_the_kernels_short_chains():
    # K4's dS k over 2,048 keys: one chain of 768 truncated steps, or the
    # kernel's 32-key stages (12 steps each) added in f32.
    q, k, v, do, g_lse = inputs((1, 2048, 1, 64), seed=2)
    o, lse = tatt.flash_attention_reference(q, k, v, causal=True)
    delta = tatt.attention_delta(o, do)
    args = (q, k, v, do, lse, delta)
    want = tatt.flash_backward_dq_reference(*args, True, g_lse)
    one_chain = tile_rel_err(truncated_dq(*args, g_lse, True), want)
    per_tile = tile_rel_err(truncated_dq(*args, g_lse, False), want)
    assert one_chain > LIMIT, one_chain
    assert per_tile <= LIMIT / 5, per_tile
