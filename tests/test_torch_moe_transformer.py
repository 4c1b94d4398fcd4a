"""The port's MoE LM and its sequence + expert parallel step against the
JAX package's.

Parameters come from JAX's ``init_moe_lm_state`` through
``convert.moe_lm_state_from_numpy``. The sharded programs run as gloo
ranks on the CPU (one spawn a world size, 2 and 4); JAX runs its own on
the conftest's virtual devices.

Tolerances. Inside the port, the EP dispatch relocates work and nothing
else: the composed sharded forward with the all-to-all layer equals the
one whose ranks compute their shard's experts themselves to 2e-5 (the
JAX test's bound). Across packages the losses are held to 1e-3 relative
(bf16 compute rounding in other places, as the dense LM's tests state);
a router's argmax sits downstream of that rounding, which the JAX test
notes flips expert choices between two correct programs, so logits are
compared within one package only. The flips move every gradient too:
after one step each leaf's momentum (the step's gradient) lies within
0.25 of JAX's norm-wise (0.03-0.19 measured at worlds 2 and 4). With the
routers zeroed every token ties and goes to expert 0 in both packages
(argmax takes the first maximum), capacity drops by position, so no
choice can flip: then every leaf's momentum, the router's included, is
held to JAX's within 2e-2 norm-wise (at most 1.3e-2 measured). Remat
recomputes every block from its input: in the port its gradients equal
the plain ones bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from nvshare_tpu.models import moe_transformer as jmt
from nvshare_tpu.parallel.ring_attention import make_seq_mesh
from nvshare_tpu.parallel.seq_transformer import seq_sharded_moe_lm_step
from nvshare_tpu_torch.convert import moe_lm_state_from_numpy
from nvshare_tpu_torch.models import moe_transformer as tmt
from nvshare_tpu_torch.parallel import dryrun

CFG = dict(vocab=64, dim=32, heads=8, depth=2, seq=128, experts=8,
           mlp_mult=2)
JMODEL = jmt.MoETransformer(**CFG)
TMODEL = tmt.MoETransformer(**CFG)
LOSS_RTOL = 1e-3
M_REL = 0.25          # each leaf's momentum, routes free to flip
TIED_M_REL = 2e-2     # each leaf's momentum, every token on expert 0


def _numpy(tree):
    return {k: (_numpy(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def state():
    # numpy: the JAX steps donate their arguments, so each JAX run makes
    # its own arrays of these.
    params, _ = jmt.init_moe_lm_state(JMODEL)
    return _numpy(params), jmt.synthetic_tokens(JMODEL, batch=2)


def _tied(params):
    """``params`` with every router zeroed: each token ties over the
    experts and goes to expert 0."""
    return {k: ({**v, "router": np.zeros_like(v["router"])}
                if k.startswith("moe") else v) for k, v in params.items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, state):
    world = request.param
    params, toks = state
    inputs = _flat(params, "p")
    inputs.update(_flat(_tied(params), "z"))
    inputs["toks"] = toks
    base = dict(model=CFG, params="p", tokens="toks")
    cases = [
        dict(base, name="tied", case="moe_lm", steps=1, arrays=True,
             params="z"),
        dict(base, name="fwd_ep", case="moe_forward", ep=True),
        dict(base, name="fwd_local", case="moe_forward", ep=False),
        dict(base, name="step1", case="moe_lm", steps=1, arrays=True),
        dict(base, name="learn", case="moe_lm", steps=10),
        dict(base, name="remat", case="moe_lm", steps=1,
             model=dict(CFG, remat=True)),
    ]
    return world, dryrun.spawn(world, cases, device="cpu", inputs=inputs,
                               timeout_s=300)


def _jax_step(world, params, toks, steps=1, model=JMODEL):
    mesh = make_seq_mesh(world)
    repl = NamedSharding(mesh, P())
    p = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params), repl)
    o = jax.device_put({"m": jax.tree_util.tree_map(np.zeros_like,
                                                    params)}, repl)
    t = jax.device_put(jnp.asarray(toks), repl)
    step = seq_sharded_moe_lm_step(mesh, model)
    losses = []
    for _ in range(steps):
        p, o, loss = step(p, o, t)
        losses.append(float(loss))
    return p, o, losses


def test_composed_ep_dispatch_is_semantically_invisible(ranks):
    world, res = ranks
    np.testing.assert_allclose(res[0]["fwd_ep"]["logits"],
                               res[0]["fwd_local"]["logits"],
                               rtol=2e-5, atol=2e-5)
    for r in res:
        np.testing.assert_allclose(r["fwd_ep"]["aux"],
                                   r["fwd_local"]["aux"], rtol=1e-5)


def test_composed_step_matches_jax(ranks, state):
    world, res = ranks
    params, toks = state
    _, jopt, jlosses = _jax_step(world, params, toks)
    got = res[0]["step1"]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_RTOL)
    # Three steps: the losses after each update follow JAX's.
    _, _, jlosses3 = _jax_step(world, params, toks, steps=3)
    np.testing.assert_allclose(res[0]["learn"]["losses"][:3], jlosses3,
                               rtol=LOSS_RTOL)
    # Every rank ends with the same (replicated) state.
    for r in res[1:]:
        assert r["step1"]["param_sum"] == got["param_sum"]
        assert r["step1"]["m_abs"] == got["m_abs"]
    # The router gets its gradient through the composed objective (a dead
    # router is the classic MoE bug), of JAX's size. Its direction is
    # not compared: a few tokens routed to other experts (see the module
    # docstring) move it by 9-19% norm-wise at these widths.
    m = got["m/moe0/router"]
    want = np.asarray(jopt["m"]["moe0"]["router"])
    assert np.abs(m).max() > 0.0
    np.testing.assert_allclose(np.linalg.norm(m), np.linalg.norm(want),
                               rtol=0.1)
    # Every other leaf's gradient (the momentum after one step), within
    # what the flips allow.
    for k, want in _flat(jax.device_get(jopt["m"]), "m").items():
        if k.endswith("router"):
            continue
        rel = np.linalg.norm(got[k] - want) / np.linalg.norm(want)
        assert rel < M_REL, (k, rel)


def test_composed_step_gradients_match_jax_with_tied_routers(ranks, state):
    """Zeroed routers: no choice can flip between the packages, so every
    leaf's gradient, the all-to-all's backward into expert 0 and the
    all-reduce over the ranks included, is held tightly."""
    world, res = ranks
    params, toks = state
    _, jopt, jlosses = _jax_step(world, _tied(params), toks)
    want_m = _flat(jax.device_get(jopt["m"]), "m")
    for r in res:
        got = r["tied"]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_RTOL)
        for k, want in want_m.items():
            assert np.abs(want).max() > 0.0, k
            rel = np.linalg.norm(got[k] - want) / np.linalg.norm(want)
            assert rel < TIED_M_REL, (r["meta"]["rank"], k, rel)


def test_composed_train_step_learns(ranks):
    _, res = ranks
    losses = res[0]["learn"]["losses"]
    assert np.all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] - 0.3, losses


def test_moe_remat_grads_and_sharded_step(ranks, state):
    world, res = ranks
    params, toks = state
    rem = tmt.MoETransformer(**CFG, remat=True)
    tp, _ = moe_lm_state_from_numpy(params, {"m": params}, device="cpu")
    flat = tmt.flatten(tp)
    tt = torch.from_numpy(toks)
    grads = []
    for model in (TMODEL, rem):
        leaves = {k: v.detach().requires_grad_() for k, v in flat.items()}
        loss = tmt.moe_lm_objective(tmt.unflatten(leaves), model, tt)
        grads.append((loss.item(), torch.autograd.grad(
            loss, list(leaves.values()))))
    assert grads[0][0] == grads[1][0]
    for a, b in zip(grads[0][1], grads[1][1]):
        assert torch.equal(a, b)
    got = res[0]["remat"]["losses"][0]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, res[0]["step1"]["losses"][0], rtol=1e-4)


def test_single_device_moe_lm_trains_like_jax(state):
    params, _ = state
    toks = jmt.synthetic_tokens(JMODEL, batch=2, seed=1)
    jo = {"m": jax.tree_util.tree_map(np.zeros_like, params)}
    tp, to = moe_lm_state_from_numpy(params, jo, device="cpu")
    jp, jo = jax.tree_util.tree_map(jnp.asarray, (params, jo))
    tt = torch.from_numpy(toks)
    got, want = [], []
    for _ in range(8):
        jp, jo, jl = jmt.jit_moe_lm_train_step(jp, jo, jnp.asarray(toks),
                                               JMODEL)
        tp, to, tl = tmt.moe_lm_train_step(tp, to, tt, TMODEL)
        want.append(float(jl))
        got.append(float(tl))
    assert all(np.isfinite(got)), got
    assert got[-1] < got[0] - 0.2, got
    np.testing.assert_allclose(got[:3], want[:3], rtol=LOSS_RTOL)


def test_state_converter_and_init_shapes():
    params, opt = jmt.init_moe_lm_state(JMODEL)
    tp, to = moe_lm_state_from_numpy(_numpy(params), _numpy(opt),
                                     device="cpu")
    assert sorted(tp["moe0"]) == ["router", "w_down", "w_up"]
    np.testing.assert_array_equal(tp["moe1"]["w_up"].numpy(),
                                  np.asarray(params["moe1"]["w_up"]))
    own, own_opt = tmt.init_moe_lm_state(TMODEL, device="cpu")
    assert {k: tuple(v.shape) for k, v in tmt.flatten(own).items()} == \
        {k: tuple(v.shape) for k, v in tmt.flatten(tp).items()}
    assert all(float(v.abs().sum()) == 0.0
               for v in tmt.flatten(own_opt["m"]).values())
