"""The port's expert-parallel MoE against the JAX package's.

Gloo ranks on the CPU (one spawn a world size, 2 and 4) run
``moe_ffn_sharded`` on parameters carried across from a JAX
``init_moe_params`` tree; the JAX side runs its own ``moe_ffn_sharded``
and the per-shard ``moe_ffn_reference`` on the same numpy inputs.

Tolerances. Inside one package the relocation is exact: the port's
sharded layer equals its own per-shard reference to 2e-5 (the JAX test's
bound), as JAX's does. Across the packages both compute bf16 products
with f32 results, but XLA and ATen sum in other orders, and a hidden
activation rounded to bf16 may land one bf16 step (2**-8 relative) apart:
outputs are held to 1e-2 of their largest entry, and the gradients to the
JAX test's 2e-2. Routing (an f32 argmax) agrees exactly at these inputs,
so every dropped token is dropped in both.

A deviation from the reference, on purpose: experts that do not divide
over the ranks raise a ValueError up front (the JAX layer fails inside
its all-to-all).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nvshare_tpu.parallel.moe import (
    init_moe_params,
    moe_ffn_reference,
    moe_ffn_sharded,
)
from nvshare_tpu.parallel.ring_attention import make_seq_mesh
from nvshare_tpu_torch.parallel import dryrun

E, D, H, T = 8, 32, 64, 128
X_TOL = 1e-2
GRAD_TOL = 2e-2


def _tokens(seed, t=T):
    rng = np.random.RandomState(seed)
    return (rng.randn(t, D) * 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def jparams():
    return init_moe_params(jax.random.PRNGKey(0), E, D, H)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, jparams):
    world = request.param
    inputs = {f"moe/{k}": np.asarray(v) for k, v in jparams.items()}
    inputs.update({f"x{s}": _tokens(s) for s in range(3)})
    bad = init_moe_params(jax.random.PRNGKey(1), 6, D, H)
    inputs.update({f"bad/{k}": np.asarray(v) for k, v in bad.items()})
    base = dict(case="moe_ffn", experts=E, d=D, hidden=H, params="moe")
    cases = [
        dict(base, name="exact", x="x0"),
        dict(base, name="exact_check", x="x0", check=True),
        dict(base, name="drops", x="x1", capacity_factor=0.25),
        dict(base, name="drops_check", x="x1", capacity_factor=0.25,
             check=True),
        dict(base, name="grads", x="x2", grads=True),
        # 6 experts over 4 ranks (and 3 over 2) cannot shard.
        dict(base, name="bad", x="x0", params="bad",
             experts=6 if world == 4 else 3, expect_error=True),
    ]
    return world, dryrun.spawn(world, cases, device="cpu", inputs=inputs,
                               timeout_s=240)


def _per_shard(params, x, n, cf=1.25):
    outs, auxes = [], []
    for shard in jnp.split(jnp.asarray(x), n):
        o, a = moe_ffn_reference(params, shard, E, capacity_factor=cf)
        outs.append(o)
        auxes.append(a)
    return jnp.concatenate(outs), jnp.stack(auxes).mean()


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6))


def test_ep_matches_jax_and_per_shard_reference(ranks, jparams):
    world, res = ranks
    x = _tokens(0)
    want, aux_want = moe_ffn_sharded(make_seq_mesh(world, axis="ep"),
                                     E)(jparams, jnp.asarray(x))
    ref, _ = _per_shard(jparams, x, world)
    np.testing.assert_allclose(np.asarray(want), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    got = res[0]["exact"]
    _close(got["out"], want, X_TOL)
    np.testing.assert_allclose(got["aux"], float(aux_want), rtol=1e-5)
    # Within the port: each rank's shard equals its own per-shard
    # reference, as tight as the JAX test holds JAX's.
    for r in res:
        assert r["exact_check"]["max_abs_err"] <= 2e-5, r["exact_check"]
        assert r["exact"]["aux"] == got["aux"]


def test_capacity_drops_tokens_to_zero(ranks, jparams):
    world, res = ranks
    want, _ = _per_shard(jparams, _tokens(1), world, cf=0.25)
    got = res[0]["drops"]["out"]
    _close(got, want, X_TOL)
    zero_rows = np.all(np.asarray(want) == 0.0, axis=-1)
    assert zero_rows.any(), "expected dropped tokens at cf=0.25"
    assert np.all(got[zero_rows] == 0.0)
    assert np.array_equal(np.all(got == 0.0, axis=-1), zero_rows)
    for r in res:
        assert r["drops_check"]["max_abs_err"] <= 2e-5
        assert r["drops_check"]["dropped_rows"] > 0


def test_ep_gradients_match_jax(ranks, jparams):
    world, res = ranks
    x = jnp.asarray(_tokens(2))

    def loss_ref(p):
        out, aux = _per_shard(p, x, world)
        return jnp.sum(out.astype(jnp.float32) ** 2) + 0.01 * aux

    want = jax.grad(loss_ref)(jparams)
    for k, w in want.items():
        g = res[0]["grads"][f"grad/{k}"]
        w = np.asarray(w)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < GRAD_TOL, (k, rel)
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"grad {k}")


def test_experts_not_divisible_raises(ranks):
    _, res = ranks
    for r in res:
        err = r["bad"]["error"]
        assert err.startswith("ValueError") and "do not divide" in err, err
