"""Parity of the port's transformer inference path with the JAX package's.

The JAX parameters (``Transformer.init``) and the seeded synthetic tokens
are carried across as numpy arrays through ``nvshare_tpu_torch.convert``;
the JAX side runs as its own tests run it (flash attention in Pallas
interpret mode on the CPU), the port on ``device="cpu"``. Tolerance rtol
and atol 2e-2, the JAX decode test's: both run bf16 compute with f32
accumulation, and bf16 rounds at other places in the two frameworks.
Argmax agreement must exceed 0.95 (near-ties may differ).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvshare_tpu.models import decode as jdec
from nvshare_tpu.models import transformer as jtf
from nvshare_tpu.ops.rope import rope_rotate as j_rope
from nvshare_tpu_torch.convert import (
    kv_cache_from_numpy,
    transformer_params_from_numpy,
)
from nvshare_tpu_torch.models import decode as tdec
from nvshare_tpu_torch.models import transformer as ttf
from nvshare_tpu_torch.ops.rope import rope_rotate

TOL = dict(rtol=2e-2, atol=2e-2)
WIDE = dict(vocab=64, dim=128, heads=4, depth=2, seq=128)
SMALL = dict(vocab=64, dim=32, heads=4, depth=2, seq=32)


def pair(rope=False, **shape):
    shape = shape or WIDE
    return jtf.Transformer(rope=rope, **shape), ttf.Transformer(rope=rope,
                                                                **shape)


def carried(jmodel, seed):
    jp = jmodel.init(seed=seed)
    tp = transformer_params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    return jp, tp


def assert_logits_close(got, want):
    np.testing.assert_allclose(got, want, **TOL)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree > 0.95, agree


@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
def test_transformer_forward_matches_jax(rope):
    jm, tm = pair(rope)
    jp, tp = carried(jm, seed=0)
    toks = jtf.synthetic_tokens(jm, batch=2)[:, :jm.seq]
    np.testing.assert_array_equal(ttf.synthetic_tokens(tm, 2)[:, :tm.seq],
                                  toks)
    want = np.asarray(jtf.transformer_forward(jp, jm, jnp.asarray(toks)))
    got = ttf.transformer_forward(tp, tm, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 128, 64)
    assert_logits_close(got.numpy(), want)


@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
def test_teacher_forced_decode_matches_jax(rope):
    # Feeding a fixed sequence one position at a time through the cache
    # reproduces the full forward's logits (the JAX decode test's check,
    # at its tolerance), the JAX forward's, and JAX's own decode_step.
    jm, tm = pair(rope)
    jp, tp = carried(jm, seed=1)
    toks = jtf.synthetic_tokens(jm, batch=2, seed=1)[:, :jm.seq]
    n = 32
    full = ttf.transformer_forward(tp, tm, torch.from_numpy(toks)).numpy()
    jfull = np.asarray(jtf.transformer_forward(jp, jm, jnp.asarray(toks)))
    jstep = jax.jit(jdec.decode_step, static_argnums=(1,))
    jcache = jdec.init_kv_cache(jm, batch=2, max_len=n)
    tcache = kv_cache_from_numpy(
        {k: np.asarray(v, np.float32) for k, v in jcache.items()},
        device="cpu")
    got, want = [], []
    for pos in range(n):
        jl, jcache = jstep(jp, jm, jcache, pos, jnp.asarray(toks[:, pos]))
        tl, tcache = tdec.decode_step(tp, tm, tcache, pos,
                                      torch.from_numpy(toks[:, pos]))
        want.append(np.asarray(jl))
        got.append(tl.numpy())
    got, want = np.stack(got, 1), np.stack(want, 1)
    assert_logits_close(got, full[:, :n])
    assert_logits_close(got, jfull[:, :n])
    # JAX's jitted decode_step itself differs from JAX's forward by up to
    # about 1.5x the 2e-2 tolerance at these widths (bf16 rounds after
    # other fusions), so the two decode paths are held to twice it.
    np.testing.assert_allclose(got, want, rtol=4e-2, atol=4e-2)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.95
    for name in jcache:
        np.testing.assert_allclose(tcache[name].float().numpy(),
                                   np.asarray(jcache[name], np.float32),
                                   rtol=4e-2, atol=4e-2)


def test_decode_updates_the_cache_in_place():
    _, tm = pair(**SMALL)
    params = tm.init(seed=2, device="cpu")
    cache = tdec.init_kv_cache(tm, batch=2, max_len=8, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    _, new = tdec.decode_step(params, tm, cache, 3, torch.tensor([1, 2]))
    assert {k: v.data_ptr() for k, v in new.items()} == ptrs
    assert all(v[:, 3].abs().sum() > 0 for v in new.values())
    assert all(v[:, 4:].abs().sum() == 0 for v in new.values())


def test_greedy_generate_keeps_the_prompt_and_extends_it():
    jm, tm = pair(**SMALL)
    _, tp = carried(jm, seed=1)
    prompt = torch.from_numpy(
        ttf.synthetic_tokens(tm, batch=2, seed=1)[:, :8])
    out = tdec.greedy_generate(tp, prompt, tm, 6)
    assert out.shape == (2, 14)
    np.testing.assert_array_equal(out[:, :8].numpy(), prompt.numpy())
    assert out.min() >= 0 and out.max() < tm.vocab
    # The same continuation, by a hand loop of decode_step with argmax.
    cache = tdec.init_kv_cache(tm, 2, 14, device="cpu")
    token = prompt[:, 0]
    for pos in range(13):
        logits, cache = tdec.decode_step(tp, tm, cache, pos, token)
        token = prompt[:, pos + 1] if pos + 1 < 8 else logits.argmax(-1)
        np.testing.assert_array_equal(out[:, pos + 1].numpy(),
                                      token.numpy())


def test_sample_generate_topk1_is_greedy_and_deterministic():
    _, tm = pair(**SMALL)
    params = tm.init(seed=3, device="cpu")
    prompt = torch.from_numpy(ttf.synthetic_tokens(tm, batch=2,
                                                   seed=3)[:, :6])
    greedy = tdec.greedy_generate(params, prompt, tm, 6)

    def sample(seed, temperature, top_k):
        gen = torch.Generator().manual_seed(seed)
        return tdec.sample_generate(params, prompt, tm, 6, gen,
                                    temperature, top_k)

    np.testing.assert_array_equal(sample(0, 1.0, 1).numpy(),
                                  greedy.numpy())
    np.testing.assert_array_equal(sample(1, 1e-4, 0).numpy(),
                                  greedy.numpy())
    hot = [sample(s, 2.0, 0).numpy() for s in (0, 0, 1, 2)]
    np.testing.assert_array_equal(hot[0], hot[1])
    for o in hot:
        np.testing.assert_array_equal(o[:, :6], prompt.numpy())
        assert o.min() >= 0 and o.max() < tm.vocab
    assert not (np.array_equal(hot[1], hot[2])
                and np.array_equal(hot[2], hot[3]))


def test_rope_rotate_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 16, 3, 8).astype(np.float32)
    pos = np.arange(5, 21)
    want = np.asarray(j_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = rope_rotate(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    xb = torch.from_numpy(x).bfloat16()
    assert rope_rotate(xb, torch.from_numpy(pos)).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="even head dim"):
        rope_rotate(torch.zeros(1, 2, 1, 3), torch.arange(2))


def test_init_has_the_jax_names_shapes_and_scales():
    jm, tm = pair()
    jp = jm.init(seed=0)
    tp = tm.init(seed=0, device="cpu")
    assert list(tp) == list(jp)
    for name, w in tp.items():
        assert tuple(w.shape) == tuple(jp[name].shape), name
        assert w.dtype == torch.float32
        want_std = float(np.asarray(jp[name]).std())
        assert abs(float(w.std()) - want_std) <= 0.1 * want_std + 1e-6, name
    again = tm.init(seed=0, device="cpu")
    assert all(torch.equal(again[k], tp[k]) for k in tp)
    meta = tm.init(seed=0, device="meta")
    assert all(v.device.type == "meta" for v in meta.values())
    cache = tdec.init_kv_cache(tm, 3, 16, device="cpu")
    jcache = jdec.init_kv_cache(jm, 3, 16)
    assert list(cache) == list(jcache)
    assert all(v.dtype == torch.bfloat16 and v.shape == (3, 16, 4, 32)
               for v in cache.values())
