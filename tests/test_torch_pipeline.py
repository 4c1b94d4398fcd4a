"""The port's GPipe pipeline against the JAX package's.

Stacked stage parameters come from JAX's ``init_pipeline_params`` /
``init_transformer_stage_params``; each rank takes its slice
(``convert.pipeline_params_from_numpy``). Gloo ranks on the CPU, one
stage a rank, world 2 and 4. The schedule is invisible: the pipeline's
output equals the stages run in order on one device, and a train step's
update equals differentiating that composition.

Tolerances. Against JAX's sequential composition, the MLP stage's bf16
product may round one bf16 step apart (2**-8 relative) before the gelu:
outputs and losses are held to 1e-3, the updated parameters to 2e-4 (the
JAX test's bound; an update moves them by lr x gradient). Transformer
stages run at f32 compute for the schedule's exactness, as in the JAX
test: 2e-4 (summation order across the packages' attention and
products).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvshare_tpu.parallel import pipeline as jpp
from nvshare_tpu.parallel.ring_attention import make_seq_mesh
from nvshare_tpu_torch.convert import pipeline_params_from_numpy
from nvshare_tpu_torch.parallel import dryrun

D, MB = 32, 4
T_D, T_SEQ, T_MB, T_M = 32, 128, 2, 4


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _data(seed, m, shape):
    rng = np.random.RandomState(seed)
    return [(rng.randn(m, *shape) * 0.5).astype(np.float32)
            for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _setup(world):
    m = 4 * world
    inputs = {}
    for name, seed in (("fwd", 0), ("step", 1), ("learn", 2)):
        p = _np(jpp.init_pipeline_params(jax.random.PRNGKey(seed), world, D))
        inputs.update({f"{name}/{k}": v for k, v in p.items()})
        xs, ys = _data(seed, m, (MB, D))
        inputs[f"{name}_xs"], inputs[f"{name}_ys"] = xs, ys
    tp = _np(jpp.init_transformer_stage_params(jax.random.PRNGKey(4), world,
                                               T_D))
    inputs.update({f"tf/{k}": v for k, v in tp.items()})
    xs, _ = _data(4, T_M, (T_MB, T_SEQ, T_D))
    inputs["tf_xs"] = inputs["tf_ys"] = xs
    base = dict(case="pipeline", d=D)
    tf = dict(case="pipeline", stage="transformer", heads=4, params="tf",
              xs="tf_xs", ys="tf_ys")
    cases = [
        dict(base, name="fwd", mode="forward", params="fwd", xs="fwd_xs",
             ys="fwd_ys"),
        dict(base, name="step", params="step", xs="step_xs", ys="step_ys"),
        dict(base, name="learn", params="learn", xs="learn_xs",
             ys="learn_xs", steps=12, lr=5e-2),
        dict(tf, name="tf_fwd", mode="forward", compute="float32"),
        dict(tf, name="tf_step", compute="float32"),
        dict(tf, name="tf_bf16", steps=4),
    ]
    return inputs, dryrun.spawn(world, cases, device="cpu", inputs=inputs,
                                timeout_s=300)


def _stage(params, s):
    return jax.tree_util.tree_map(lambda a: a[s], params)


def _sequential(stage_fn, params, xs, world):
    outs = []
    for i in range(xs.shape[0]):
        h = xs[i]
        for s in range(world):
            h = stage_fn(_stage(params, s), h)
        outs.append(h.astype(jnp.float32))
    return jnp.stack(outs)


def _stacked(inputs, prefix):
    return {k.split("/", 1)[1]: jnp.asarray(v) for k, v in inputs.items()
            if k.startswith(prefix + "/")}


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_forward_matches_sequential(world):
    inputs, res = _setup(world)
    params = _stacked(inputs, "fwd")
    want = _sequential(jpp.mlp_stage, params, jnp.asarray(inputs["fwd_xs"]),
                       world)
    got = res[0]["fwd"]["out"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-3)
    jgot = jpp.pipeline_forward_sharded(
        make_seq_mesh(world, axis="pp"))(params, jnp.asarray(inputs["fwd_xs"]))
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_train_step_matches_sequential_grads(world):
    inputs, res = _setup(world)
    params = _stacked(inputs, "step")
    xs, ys = jnp.asarray(inputs["step_xs"]), jnp.asarray(inputs["step_ys"])
    lr = 1e-2

    def seq_loss(p):
        out = _sequential(jpp.mlp_stage, p, xs, world)
        return jnp.mean((out - ys) ** 2)

    loss_want, grads = jax.value_and_grad(seq_loss)(params)
    want = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    for r in res:
        np.testing.assert_allclose(r["step"]["losses"][0], float(loss_want),
                                   rtol=1e-3)
    for k in want:
        got = np.concatenate([r["step"][f"params/{k}"] for r in res])
        np.testing.assert_allclose(got, np.asarray(want[k]), rtol=2e-4,
                                   atol=2e-4, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_training_learns(world):
    # Twelve steps toward ys = xs (the residual blocks learn to add
    # nothing), loss by loss against JAX's pipeline step on the same
    # stacked params; with 2 or 4 stages (not the JAX test's 8) the loss
    # falls by 9-41%, so the curve, not a halving, is what is held.
    inputs, res = _setup(world)
    params = _stacked(inputs, "learn")
    xs = jnp.asarray(inputs["learn_xs"])
    step = jpp.pipeline_train_step(make_seq_mesh(world, axis="pp"),
                                   lr=5e-2)
    want = []
    for _ in range(12):
        params, loss = step(params, xs, xs)
        want.append(float(loss))
    losses = res[0]["learn"]["losses"]
    assert np.all(np.isfinite(losses))
    assert np.all(np.diff(losses) < 0), losses
    np.testing.assert_allclose(losses, want, rtol=2e-3)


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_transformer_blocks(world):
    # Whole transformer blocks as stages (the flash kernel's plain
    # version inside the schedule), f32 compute.
    from functools import partial

    inputs, res = _setup(world)
    params = _stacked(inputs, "tf")
    stage = partial(jpp.transformer_stage, heads=4,
                    compute_dtype=jnp.float32)
    xs = jnp.asarray(inputs["tf_xs"])
    want = _sequential(stage, params, xs, world)
    np.testing.assert_allclose(res[0]["tf_fwd"]["out"], np.asarray(want),
                               rtol=2e-4, atol=2e-4)

    def seq_loss(p):
        return jnp.mean((_sequential(stage, p, xs, world) - xs) ** 2)

    loss_want, grads = jax.value_and_grad(seq_loss)(params)
    np.testing.assert_allclose(res[0]["tf_step"]["losses"][0],
                               float(loss_want), rtol=1e-4)
    for k, g in grads.items():
        new = np.concatenate([r["tf_step"][f"params/{k}"] for r in res])
        np.testing.assert_allclose(new, np.asarray(params[k] - 1e-2 * g),
                                   rtol=2e-4, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_transformer_train_step_runs_bf16(world):
    _, res = _setup(world)
    losses = res[0]["tf_bf16"]["losses"]
    assert np.all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses


def test_pipeline_params_from_numpy_slices_one_stage():
    p = _np(jpp.init_pipeline_params(jax.random.PRNGKey(0), 4, D))
    for rank in range(4):
        local = pipeline_params_from_numpy(p, rank, device="cpu")
        assert local["w"].shape == (1, D, D)
        assert torch.equal(local["w"][0],
                           torch.from_numpy(np.array(p["w"][rank])))
