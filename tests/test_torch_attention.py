"""Parity of the port's flash attention with the JAX package's on the CPU.

The same seeded numpy inputs go through ``nvshare_tpu.ops.attention``
(Pallas in interpret mode, as the JAX package's own tests run it) and
through ``nvshare_tpu_torch.ops.attention`` on CPU tensors, where the
wrappers run their plain PyTorch version. The CUDA kernels themselves are
held against that plain version on the card by ``chip_smoke.py``.
Tolerances are the JAX kernel tests': 2e-5 in f32 and 2e-2 in bf16 for
the forward; 2e-4 in f32 and 5e-2 in bf16 for the gradients, which the
backward accumulates over every key or query of a row.
"""

import numpy as np
import pytest
import torch

import jax
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


# -- gradients -------------------------------------------------------------

GRAD_TOL = {False: dict(rtol=2e-4, atol=2e-4), True: dict(rtol=5e-2,
                                                          atol=5e-2)}


def _grads_jax(fn, xs, bf16, causal, loss):
    return jax.grad(lambda q, k, v: loss(fn(q, k, v, causal=causal)),
                    argnums=(0, 1, 2))(*as_jax(xs, bf16))


def _grads_torch(xs, bf16, causal, loss, fn=None):
    prim = [x.requires_grad_() for x in as_torch(xs, bf16)]
    fn = fn or tatt.flash_attention
    loss(fn(*prim, causal=causal)).backward()
    return [x.grad for x in prim]


GRAD_CASES = {
    # name: (inputs, causal, bf16, loss as the JAX kernel test writes it)
    "full": (qkv(4, b=2, sq=128, h=2, d=32), False, False, "square"),
    "causal": (qkv(4, b=2, sq=128, h=2, d=32), True, False, "square"),
    # 4 x 4 tiles of 128: the causal tile skip and both sweeps' loops.
    "multi_tile_causal": (qkv(6, b=2, sq=512, h=1, d=64), True, False,
                          "cos"),
    "q<k_full": (qkv(7, b=1, sq=128, sk=256), False, False, "square"),
    "q<k_causal": (qkv(7, b=1, sq=128, sk=256), True, False, "square"),
    "q>k_full": (qkv(7, b=1, sq=256, sk=128), False, False, "square"),
    "q>k_causal": (qkv(7, b=1, sq=256, sk=128), True, False, "square"),
    "bf16_causal": (qkv(8), True, True, "square"),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_flash_gradients_match_jax(case):
    xs, causal, bf16, kind = GRAD_CASES[case]
    if kind == "cos":
        jloss, tloss = (lambda o: jnp.sum(jnp.cos(o))), \
            (lambda o: torch.cos(o).sum())
    else:
        jloss = lambda o: jnp.sum(o.astype(jnp.float32) ** 2)  # noqa: E731
        tloss = lambda o: (o.float() ** 2).sum()  # noqa: E731
    want = _grads_jax(j_flash, xs, bf16, causal, jloss)
    got = _grads_torch(xs, bf16, causal, tloss)
    for g, w in zip(got, want):
        assert g.dtype == (torch.bfloat16 if bf16 else torch.float32)
        np.testing.assert_allclose(f32(g), f32(w), **GRAD_TOL[bf16])


def test_lse_cotangent_folds_into_the_gradients():
    # A loss of both outputs (as the ring combine differentiates them):
    # d(lse)/ds is p, so the LSE cotangent reaches q and k through dS.
    xs = qkv(10)
    rng = np.random.RandomState(11)
    w_out = rng.randn(2, 256, 2, 64).astype(np.float32)
    w_lse = rng.randn(4, 256).astype(np.float32)

    def jloss(q, k, v):
        o, lse = j_flash_lse(q, k, v, True)
        return jnp.sum(o * w_out) + jnp.sum(lse * w_lse)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*as_jax(xs, False))
    prim = [x.requires_grad_() for x in as_torch(xs, False)]
    o, lse = tatt.flash_attention_lse(*prim, causal=True)
    ((o * torch.from_numpy(w_out)).sum()
     + (lse * torch.from_numpy(w_lse)).sum()).backward()
    for g, w in zip(prim, want):
        np.testing.assert_allclose(f32(g.grad), f32(w), **GRAD_TOL[False])
    # Without the LSE term the gradients differ: the cotangent mattered.
    plain = _grads_torch(xs, False, True,
                         lambda o: (o * torch.from_numpy(w_out)).sum())
    assert not np.allclose(f32(plain[0]), f32(prim[0].grad), atol=1e-3)


def test_ragged_route_gradient_matches_jax():
    # seq 100: the oracle carries forward and backward on both sides.
    xs = qkv(12, sq=100)
    loss = lambda o: jnp.sum(o ** 2)  # noqa: E731
    want = _grads_jax(j_flash, xs, False, True, loss)
    got = _grads_torch(xs, False, True, lambda o: (o ** 2).sum())
    for g, w in zip(got, want):
        np.testing.assert_allclose(f32(g), f32(w), **GRAD_TOL[False])


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_backward_reference_is_autograd_of_the_plain_forward(causal):
    # The plain backward (p from the saved LSE, then dP, dS and the three
    # products) against PyTorch's autograd through the plain forward, in
    # f32 on the same inputs: only summation order differs (1e-5).
    q, k, v = (x.requires_grad_() for x in as_torch(qkv(13, sk=128), False))
    o, lse = tatt.flash_attention_reference(q, k, v, causal=causal)
    do = torch.from_numpy(
        np.random.RandomState(14).randn(*o.shape).astype(np.float32))
    g_lse = torch.from_numpy(
        np.random.RandomState(15).randn(*lse.shape).astype(np.float32))
    want = torch.autograd.grad((o * do).sum() + (lse * g_lse).sum(),
                               (q, k, v))
    args = (q.detach(), k.detach(), v.detach(), do, lse.detach(),
            tatt.attention_delta(o.detach(), do), causal, g_lse)
    got = tatt.flash_backward_reference(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # Each kernel's plain version is its part of the whole.
    np.testing.assert_array_equal(
        tatt.flash_backward_dq_reference(*args).numpy(), got[0].numpy())
    for g, w in zip(tatt.flash_backward_dkv_reference(*args), got[1:]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_backward_wrappers_never_launch_on_cpu_or_meta():
    q, k, v = as_torch(qkv(16), True)
    o, lse = tatt.flash_attention_lse(q, k, v, causal=True)
    delta = tatt.attention_delta(o, o)
    counts = (tatt.flash_backward_dq.launches,
              tatt.flash_backward_dkv.launches)
    before = [c.value for c in counts]
    dq = tatt.flash_backward_dq(q, k, v, o, lse, delta, True)
    dk, dv = tatt.flash_backward_dkv(q, k, v, o, lse, delta, True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    meta = [torch.empty(x.shape, dtype=x.dtype, device="meta",
                        requires_grad=True) for x in (q, k, v)]
    tatt.flash_attention(*meta, causal=True).sum().backward()
    assert all(x.grad.device.type == "meta" and x.grad.shape == x.shape
               for x in meta)
    assert [c.value for c in counts] == before
