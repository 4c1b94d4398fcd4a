"""Parity of the port's flash attention with the JAX package's on the CPU.

The same seeded numpy inputs go through ``nvshare_tpu.ops.attention``
(Pallas in interpret mode, as the JAX package's own tests run it) and
through ``nvshare_tpu_torch.ops.attention`` on CPU tensors, where the
wrappers run their plain PyTorch version. The CUDA kernel itself is held
against that plain version on the card by ``chip_smoke.py``. Tolerances
are the JAX kernel test's: 2e-5 in f32, 2e-2 in bf16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nvshare_tpu.ops.attention import flash_attention as j_flash
from nvshare_tpu.ops.attention import flash_attention_lse as j_flash_lse
from nvshare_tpu.parallel.ring_attention import reference_attention as j_ref
from nvshare_tpu_torch.ops import attention as tatt

TOL = {np.float32: dict(rtol=2e-5, atol=2e-5),
       "bf16": dict(rtol=2e-2, atol=2e-2)}


def qkv(seed, b=2, sq=256, h=2, d=64, sk=None):
    rng = np.random.RandomState(seed)
    sk = sq if sk is None else sk
    return (rng.randn(b, sq, h, d).astype(np.float32) * 0.5,
            rng.randn(b, sk, h, d).astype(np.float32) * 0.5,
            rng.randn(b, sk, h, d).astype(np.float32) * 0.5)


def as_jax(xs, bf16):
    return [jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
            for x in xs]


def as_torch(xs, bf16):
    return [torch.from_numpy(x).to(torch.bfloat16 if bf16 else
                                   torch.float32) for x in xs]


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_and_lse_match_jax(causal, bf16):
    xs = qkv(0)
    tol = TOL["bf16" if bf16 else np.float32]
    want_o, want_l = j_flash_lse(*as_jax(xs, bf16), causal)
    got_o, got_l = tatt.flash_attention_lse(*as_torch(xs, bf16),
                                            causal=causal)
    assert got_o.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert got_l.dtype == torch.float32 and got_l.shape == (4, 256)
    np.testing.assert_allclose(f32(got_o), f32(want_o), **tol)
    # The LSE stays f32 whatever the input type (the same rounded
    # inputs on both sides), so it holds to the f32 tolerance.
    np.testing.assert_allclose(f32(got_l), f32(want_l), **TOL[np.float32])
    plain = tatt.flash_attention(*as_torch(xs, bf16), causal=causal)
    np.testing.assert_array_equal(f32(plain), f32(got_o))
    np.testing.assert_allclose(
        f32(plain), f32(j_flash(*as_jax(xs, bf16), causal=causal)), **tol)


@pytest.mark.parametrize("case", ["multi_qtile_causal", "cross_length",
                                  "cross_length_causal"])
def test_flash_attention_shapes_match_jax(case):
    # 512-long sequences: 4 x 4 tiles of 128, so the causal tile skip and
    # the running max across tiles engage; cross-length sq=128, sk=256,
    # both sequences starting at position 0.
    xs = {"multi_qtile_causal": qkv(3, sq=512, h=1),
          "cross_length": qkv(4, sq=128, sk=256),
          "cross_length_causal": qkv(5, sq=128, sk=256)}[case]
    causal = case != "cross_length"
    want_o, want_l = j_flash_lse(*as_jax(xs, False), causal)
    got_o, got_l = tatt.flash_attention_lse(*as_torch(xs, False),
                                            causal=causal)
    np.testing.assert_allclose(f32(got_o), f32(want_o), **TOL[np.float32])
    np.testing.assert_allclose(f32(got_l), f32(want_l), **TOL[np.float32])


def test_lse_is_the_row_logsumexp():
    q, k, v = as_torch(qkv(6), False)
    _, lse = tatt.flash_attention_lse(q, k, v, causal=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 8.0
    s = s.masked_fill(torch.ones(256, 256).triu(1).bool(), float("-inf"))
    want = torch.logsumexp(s, dim=-1).reshape(4, 256)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("sq,d", [(100, 64), (128, 160)],
                         ids=["ragged_seq", "oversized_dim"])
def test_ragged_route_is_the_reference(sq, d):
    xs = qkv(7, sq=sq, d=d)
    got = tatt.flash_attention(*as_torch(xs, False), causal=True)
    want = j_ref(*as_jax(xs, False), causal=True)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[np.float32])
    with pytest.raises(ValueError, match="kernel-eligible"):
        tatt.flash_attention_lse(*as_torch(xs, False))


def test_backward_raises_until_the_backward_kernels_exist():
    q, k, v = (x.requires_grad_() for x in as_torch(qkv(8), False))
    out = tatt.flash_attention(q, k, v, causal=True)
    with pytest.raises(NotImplementedError, match="backward"):
        out.sum().backward()


def test_cpu_and_meta_tensors_never_launch_the_kernel():
    xs = as_torch(qkv(9), True)
    before = tatt.flash_attention.launches.value
    tatt.flash_attention(*xs, causal=True)
    tatt.flash_attention_lse(*xs)
    meta = [torch.empty(x.shape, dtype=x.dtype, device="meta") for x in xs]
    out, lse = tatt.flash_attention_lse(*meta, causal=True)
    assert out.device.type == "meta" and lse.shape == (4, 256)
    assert tatt.flash_attention.launches.value == before
    assert tatt.flash_attention_lse.launches is tatt.flash_attention.launches
