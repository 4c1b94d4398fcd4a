"""The port's sequence-parallel LM steps against the JAX package's.

One step of ``seq_sharded_lm_step`` (ring and Ulysses; gloo ranks on the
CPU, world 2 and 4) from JAX's ``init_lm_state`` (carried across by
``convert``) must be the single-device step: held to JAX's
``jit_lm_train_step`` with the dense LM's cross-package tolerances (loss
rtol 1e-3, parameters atol 1e-4, momentum 1e-2 of its largest entry: the
packages round bf16 at other places), and to the port's own
``lm_train_step`` as tightly as the JAX test holds JAX's (loss 1e-5,
parameters 2e-4). dp x sp on a 2 x 2 grid likewise; training learns, with
RoPE too; an Adam optimizer against optax's adam in JAX's
sequence-parallel step.

A deviation from the reference, on purpose: ``lr`` defaults to ``None``,
so ANY explicit ``lr`` beside an optimizer is refused (JAX's sentinel
``lr != 1e-2`` lets ``lr=1e-2`` through with a ``tx``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from nvshare_tpu.models import transformer as jtf
from nvshare_tpu.parallel.ring_attention import make_seq_mesh
from nvshare_tpu.parallel.seq_transformer import seq_sharded_lm_step
from nvshare_tpu_torch.models.transformer import Transformer
from nvshare_tpu_torch.parallel import Mesh, dryrun
from nvshare_tpu_torch.parallel import seq_transformer as tseq

CFG = dict(vocab=64, dim=32, heads=8, depth=2, seq=128)
JMODEL = jtf.Transformer(**CFG)
ROPE = dict(vocab=64, dim=32, heads=8, depth=1, seq=128, rope=True)
M_REL = 1e-2


@functools.lru_cache(maxsize=None)
def _state():
    params, _ = jtf.init_lm_state(JMODEL)
    return ({k: np.asarray(v) for k, v in params.items()},
            jtf.synthetic_tokens(JMODEL, batch=4))


@functools.lru_cache(maxsize=None)
def _ranks(world):
    """One spawn a world size, every case of it (made once a module)."""
    params, toks = _state()
    inputs = {f"p/{k}": v for k, v in params.items()}
    inputs["toks"] = toks
    base = dict(case="seq_lm", model=CFG, params="p", tokens="toks",
                arrays=True)
    cases = [dict(base, name="ring", attn="ring"),
             dict(base, name="ulysses", attn="ulysses"),
             dict(base, name="single", case="lm_single")]
    if world == 2:
        cases += [dict(base, name="learn", attn="ring", steps=10,
                       arrays=False, params=None, seed=1, batch=4),
                  dict(base, name="adam", attn="ring", steps=3,
                       optimizer="adam", opt_args=dict(lr=3e-3))]
    else:
        cases += [dict(base, name="dp_sp", mesh=[2, 2]),
                  dict(name="dp_sp_rope", case="seq_lm", model=ROPE,
                       mesh=[2, 2], steps=8, batch=4)]
    return dryrun.spawn(world, cases, device="cpu", inputs=inputs,
                        timeout_s=300)


@pytest.fixture(scope="module")
def state():
    return _state()


def _jax_single(params, toks):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    o = {"m": {k: jnp.zeros_like(v) for k, v in p.items()}}
    p, o, loss = jtf.jit_lm_train_step(p, o, jnp.asarray(toks), JMODEL)
    return p, o, float(loss)


def _held(res, params, toks, own):
    jp, jo, jloss = _jax_single(params, toks)
    np.testing.assert_allclose(res["losses"][0], jloss, rtol=1e-3)
    np.testing.assert_allclose(res["losses"][0], own["losses"][0],
                               rtol=1e-5)
    for k in jp:
        np.testing.assert_allclose(res[f"params/{k}"], np.asarray(jp[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(res[f"params/{k}"], own[f"params/{k}"],
                                   rtol=2e-4, atol=2e-4, err_msg=k)
        m = np.asarray(jo["m"][k])
        np.testing.assert_allclose(res[f"m/{k}"], m, rtol=0,
                                   atol=M_REL * np.abs(m).max(), err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_seq_sharded_step_matches_single_device(state, world, attn):
    res = _ranks(world)
    params, toks = state
    _held(res[0][attn], params, toks, res[0]["single"])
    # Replicated state: every rank made the same update.
    for r in res[1:]:
        assert r[attn]["param_sum"] == res[0][attn]["param_sum"]
        assert r[attn]["m_abs"] == res[0][attn]["m_abs"]
    assert res[0]["meta"]["cases"][attn]["transport"]["all_reduce"][
        "calls"] == 1   # the gradients and the loss cross once


def test_seq_sharded_training_learns():
    res = _ranks(2)
    losses = res[0]["learn"]["losses"]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.4, losses


def test_dp_seq_2d_mesh_matches_single_device(state):
    res = _ranks(4)      # dp x sp on a 2 x 2 grid
    params, toks = state
    _held(res[0]["dp_sp"], params, toks, res[0]["single"])
    for r in res[1:]:
        assert r["dp_sp"]["param_sum"] == res[0]["dp_sp"]["param_sum"]


def test_dp_seq_2d_mesh_learns_with_rope():
    res = _ranks(4)
    losses = res[0]["dp_sp_rope"]["losses"]
    assert np.all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] - 0.3, losses


def test_optimizer_step_matches_optax(state):
    res = _ranks(2)
    params, toks = state
    mesh = make_seq_mesh(2)
    repl = NamedSharding(mesh, P())
    tx = optax.adam(3e-3)
    p = jax.device_put({k: jnp.asarray(v) for k, v in params.items()}, repl)
    o = jax.device_put(tx.init(p), repl)
    t = jax.device_put(jnp.asarray(toks), repl)
    step = seq_sharded_lm_step(mesh, JMODEL, tx=tx)
    want = []
    for _ in range(3):
        p, o, loss = step(p, o, t)
        want.append(float(loss))
    got = res[0]["adam"]
    np.testing.assert_allclose(got["losses"], want, rtol=1e-3)
    # Adam moves every entry by about lr a step whatever its gradient's
    # size, so an entry whose gradient is near zero, of another sign in
    # the other package, may land up to 2 x lr x steps away (1.8e-2); all
    # but a few entries in a thousand agree to 2e-3.
    bound = 2 * 3e-3 * 3
    for k in p:
        g, w = got[f"params/{k}"], np.asarray(p[k])
        np.testing.assert_allclose(g, w, rtol=0, atol=bound, err_msg=k)
        assert np.mean(np.abs(g - w) > 2e-3) < 5e-3, k


def test_lr_beside_an_optimizer_is_refused():
    # In one process a one-rank mesh needs no process group.
    mesh = Mesh((1,), ("seq",), device="cpu")
    model = Transformer(**CFG)
    params = model.init(0, device="cpu")
    opt = torch.optim.SGD(list(params.values()), lr=0.1)
    for lr in (1e-2, 1e-3):   # 1e-2 too: JAX's sentinel let it through
        with pytest.raises(ValueError, match="optimizer"):
            tseq.seq_sharded_lm_step(mesh, model, lr=lr, optimizer=opt)
    tseq.seq_sharded_lm_step(mesh, model, optimizer=opt)
    with pytest.raises(ValueError, match="ring"):
        tseq.seq_sharded_lm_step(mesh, model, attn="flash")


def test_one_rank_step_is_lm_train_step(state):
    # A one-rank mesh: every collective is the identity, so the step is
    # lm_train_step's bit for bit (the ring's single block is the whole
    # sequence through the flash kernel's plain version in f32).
    from nvshare_tpu_torch.convert import lm_state_from_numpy
    from nvshare_tpu_torch.models.transformer import lm_train_step

    params, toks = state
    zeros = {"m": {k: np.zeros_like(v) for k, v in params.items()}}
    model = Transformer(**CFG)
    tt = torch.from_numpy(toks)
    mesh = Mesh((1,), ("seq",), device="cpu")
    out = {}
    for attn in ("ulysses", "ring"):
        p, o = lm_state_from_numpy(params, zeros, device="cpu")
        step = tseq.seq_sharded_lm_step(mesh, model, attn=attn)
        out[attn] = step(p, o, tt)
    p, o = lm_state_from_numpy(params, zeros, device="cpu")
    want = lm_train_step(p, o, tt, model)
    # Ulysses at one rank is the local flash attention at the input dtype.
    assert float(out["ulysses"][2]) == float(want[2])
    for k in params:
        assert torch.equal(out["ulysses"][0][k], want[0][k]), k
    np.testing.assert_allclose(float(out["ring"][2]), float(want[2]),
                               rtol=1e-5)
