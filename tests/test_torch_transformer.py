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


# -- training ----------------------------------------------------------------
#
# Gradients and train steps against the JAX package's, parameters carried
# across by ``convert``. Both compute in bf16 with f32 accumulation and
# round at other places (XLA fuses; ATen rounds every op), so a gradient
# agrees to about 4e-3 norm-wise at these widths: each is held to 1e-2
# norm-wise and, entry by entry, to 1e-2 of its largest entry. The loss
# (an f32 mean over every token) agrees to ~3e-5 relative; it is held to
# 1e-3.

GRAD_REL = 1e-2


def assert_grads_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[name].float().numpy()
        assert g.shape == w.shape, name
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < GRAD_REL, (name, rel)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
def test_lm_loss_and_gradients_match_jax(rope):
    jm, tm = pair(rope)
    jp, tp = carried(jm, seed=0)
    toks = jtf.synthetic_tokens(jm, batch=2)
    want_loss, want = jax.value_and_grad(jtf._lm_loss)(jp, jm,
                                                       jnp.asarray(toks))
    loss, grads = ttf.lm_loss_and_grads(tp, tm, torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-3)
    assert_grads_close(grads, want)
    assert float(ttf._lm_loss(tp, tm, torch.from_numpy(toks))) == float(loss)
    assert all(not p.requires_grad and p.grad is None for p in tp.values())


def test_lm_train_steps_match_jax():
    # Three momentum-SGD steps from the same state on the same batches:
    # losses, parameters and momentum against JAX's jitted step. The
    # parameters move by lr x momentum, so they agree to far below the
    # gradients' 1e-2: held to 1e-4 absolute (~1e-3 of their spread).
    from nvshare_tpu_torch.convert import lm_state_from_numpy

    jm, tm = pair()
    jparams, jopt = jtf.init_lm_state(jm, seed=2)
    params, opt = lm_state_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()},
        {"m": {k: np.asarray(v) for k, v in jopt["m"].items()}},
        device="cpu")
    jstep = jax.jit(jtf.lm_train_step, static_argnums=(3,))
    got_losses, want_losses = [], []
    for s in range(3):
        toks = jtf.synthetic_tokens(jm, batch=2, seed=10 + s)
        jparams, jopt, jl = jstep(jparams, jopt, jnp.asarray(toks), jm)
        ptrs = [p.data_ptr() for p in params.values()]
        params, opt, loss = ttf.lm_train_step(params, opt,
                                              torch.from_numpy(toks), tm)
        assert [p.data_ptr() for p in params.values()] == ptrs  # in place
        want_losses.append(float(jl))
        got_losses.append(float(loss))
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-3)
    assert got_losses[-1] < got_losses[0]
    for name in jparams:
        np.testing.assert_allclose(params[name].numpy(),
                                   np.asarray(jparams[name]), rtol=0,
                                   atol=1e-4, err_msg=name)
        m = np.asarray(jopt["m"][name])
        np.testing.assert_allclose(opt["m"][name].numpy(), m, rtol=0,
                                   atol=GRAD_REL * np.abs(m).max(),
                                   err_msg=name)


def test_sgd_momentum_update_is_the_jax_update():
    rng = np.random.RandomState(3)
    p, m, g = (rng.randn(5, 7).astype(np.float32) for _ in range(3))
    jp, jo = jtf.sgd_momentum_update({"w": jnp.asarray(p)},
                                     {"m": {"w": jnp.asarray(m)}},
                                     {"w": jnp.asarray(g)}, 0.05)
    tp, to = ttf.sgd_momentum_update({"w": torch.from_numpy(p.copy())},
                                     {"m": {"w": torch.from_numpy(m.copy())}},
                                     {"w": torch.from_numpy(g)}, 0.05)
    np.testing.assert_allclose(to["m"]["w"].numpy(), np.asarray(jo["m"]["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)


def test_remat_is_bit_identical_and_recomputes_attention():
    # As in the JAX package's remat test: the same loss and gradients bit
    # for bit, with the schedule changed: every block's forward runs
    # again in the backward, so attention is called 2 x depth times.
    from nvshare_tpu_torch.ops import flash_attention

    _, dense = pair(vocab=64, dim=32, heads=4, depth=2, seq=128)
    rem = ttf.Transformer(vocab=64, dim=32, heads=4, depth=2, seq=128,
                          remat=True)
    params = dense.init(seed=0, device="cpu")
    toks = torch.from_numpy(ttf.synthetic_tokens(dense, batch=2))
    calls = []

    def counting(q, k, v, causal):
        calls.append(q.shape)
        return flash_attention(q, k, v, causal=causal)

    l1, g1 = ttf.lm_loss_and_grads(params, dense, toks,
                                   ttf.local_attn(dense, counting))
    n_dense = len(calls)
    l2, g2 = ttf.lm_loss_and_grads(params, rem, toks,
                                   ttf.local_attn(rem, counting))
    assert (n_dense, len(calls) - n_dense) == (2, 4)
    assert float(l1) == float(l2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k
    # Without a gradient being recorded remat changes nothing either.
    with torch.no_grad():
        assert torch.equal(ttf.transformer_forward(params, rem, toks[:, :-1]),
                           ttf.transformer_forward(params, dense,
                                                   toks[:, :-1]))


def test_matmul_f32_backward_matches_jax_transpose():
    # The exact route (CPU) is JAX's transpose of a preferred_element_type
    # =f32 product: the same f32 products, summed in another order, which
    # can flip the final bf16 rounding by one ulp (2**-8 to 2**-7 of the
    # entry). The card's tensor-core route (bf16 products of the
    # bf16-rounded cotangent, f32 accumulation) differs by that rounding
    # too: held norm-wise to 5e-3, as chip_smoke.py holds it on the card.
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(64, 96), jnp.bfloat16)
    w = jnp.asarray(rng.randn(96, 80), jnp.bfloat16)
    g = rng.randn(64, 80).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jnp.matmul(
        a, b, preferred_element_type=jnp.float32), x, w)
    want = [np.asarray(t, np.float32) for t in vjp(jnp.asarray(g))]
    tx, tw = (torch.from_numpy(np.asarray(t, np.float32)).bfloat16()
              .requires_grad_() for t in (x, w))
    out = ttf._matmul_f32(tx, tw)
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(g))
    for got, ref in zip((tx.grad, tw.grad), want):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                                   atol=0)
    for got, ref in zip(ttf._matmul_f32_grads(tx.detach(), tw.detach(),
                                              torch.from_numpy(g), True),
                        want):
        assert np.linalg.norm(got.float().numpy() - ref) \
            < 5e-3 * np.linalg.norm(ref)


def test_optim_adamw_step_matches_optax_adamw():
    # torch.optim.AdamW and optax.adamw with matched hyperparameters (lr,
    # betas, eps, weight decay 1e-4): the same update up to rounding
    # (optax adds the decay to the Adam direction, torch decays the
    # parameter first: the same math). The losses are held to 1e-3. Adam
    # moves every entry by about lr whatever its gradient's size, so where
    # a gradient is near zero the two frameworks' roundings can point its
    # update either way: each parameter is held to lr / 10 in 99% of its
    # entries and to 2 lr a step (a flip every step) in all of them.
    import optax

    jm, tm = pair()
    jp, tp = carried(jm, seed=4)
    lr = 3e-3
    tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    jopt = tx.init(jp)
    jstep = jtf.make_optax_lm_step(jm, tx)
    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    opt = torch.optim.AdamW(list(leaves.values()), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    step = ttf.make_optim_lm_step(tm, opt)
    got, want = [], []
    for s in range(3):
        toks = jtf.synthetic_tokens(jm, batch=2, seed=20 + s)
        jp, jopt, jl = jstep(jp, jopt, jnp.asarray(toks))
        got.append(float(step(leaves, torch.from_numpy(toks))))
        want.append(float(jl))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]
    for name in jp:
        diff = np.abs(leaves[name].detach().numpy() - np.asarray(jp[name]))
        assert (diff <= lr / 10).mean() >= 0.99, name
        assert diff.max() <= 2 * lr * len(got), name


def test_init_lm_state_and_carried_state():
    from nvshare_tpu_torch.convert import lm_state_from_numpy

    jm, tm = pair(**SMALL)
    params, opt = ttf.init_lm_state(tm, seed=1, device="cpu")
    assert list(opt) == ["m"] and list(opt["m"]) == list(params)
    assert all(torch.count_nonzero(m) == 0 and m.shape == params[k].shape
               for k, m in opt["m"].items())
    assert all(torch.equal(params[k], v)
               for k, v in tm.init(seed=1, device="cpu").items())
    jparams, jopt = jtf.init_lm_state(jm, seed=1)
    tparams, topt = lm_state_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()},
        {"m": {k: np.asarray(v) for k, v in jopt["m"].items()}},
        device="cpu")
    for k in jparams:
        np.testing.assert_array_equal(tparams[k].numpy(),
                                      np.asarray(jparams[k]))
        assert topt["m"][k].dtype == torch.float32
