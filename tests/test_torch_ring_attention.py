"""The port's ring and Ulysses attention against the JAX package's.

The port runs as gloo ranks on the CPU (one ``dryrun.spawn`` a world
size, every case in it, numpy results back through files); the JAX side
runs ``ring_attention_sharded``/``ulysses_attention_sharded`` in this
process on the conftest's virtual CPU devices, on the same numpy inputs.
The JAX tests' cases and tolerances: f32 rtol = atol = 2e-5 (the same
math, summation order apart), bf16 inputs 2e-2, gradients through the
kernel-tile ring 2e-4. Also: the collectives against ``jax.lax``'s, the
backend rule, and the ring under the gate of one private scheduler.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvshare_tpu.parallel.ring_attention import (
    make_seq_mesh,
    reference_attention,
    ring_attention_sharded,
    ulysses_attention_sharded,
)
from nvshare_tpu_torch.parallel import collectives, dryrun
from tests.conftest import SchedulerProc

BATCH, SEQ, HEADS, DIM = 2, 64, 8, 16
F32 = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, shape):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * 0.5).astype(np.float32) for _ in range(4)]


def _cases(world):
    """(case list, inputs) of one spawn."""
    cases, inputs = [], {}

    def add(name, impl, causal, shape, seed, grads=False, dtype="float32"):
        q, k, v, do = _qkv(seed, shape)
        for n, a in zip(("q", "k", "v", "do"), (q, k, v, do)):
            inputs[f"{name}/{n}"] = a
        cases.append(dict(name=name, case="attention", impl=impl,
                          causal=causal, grads=grads, dtype=dtype,
                          qkv=name))

    for causal in (False, True):
        tag = "causal" if causal else "full"
        add(f"ring_{tag}", "ring", causal, (BATCH, SEQ, HEADS, DIM), 0)
        add(f"ulysses_{tag}", "ulysses", causal, (BATCH, SEQ, HEADS, DIM), 1)
        add(f"ring_tile_{tag}", "ring", causal, (2, 128 * world, 2, 32), 5)
    add("ring_bf16", "ring", False, (BATCH, SEQ, HEADS, DIM), 2,
        dtype="bfloat16")
    add("ring_tile_grads", "ring", True, (2, 128 * world, 1, 32), 6,
        grads=True)
    add("ring_grads", "ring", True, (BATCH, SEQ, HEADS, DIM), 7, grads=True)
    add("ulysses_tile", "ulysses", True, (1, 128, 8, 32), 4, grads=True)
    cases.append(dict(name="collectives", case="collectives"))
    return cases, inputs


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request):
    world = request.param
    cases, inputs = _cases(world)
    results = dryrun.spawn(world, cases, device="cpu", inputs=inputs,
                           timeout_s=240)
    return world, inputs, results


def _jax(world, inputs, name, impl, causal, grads=False, dtype=None):
    mesh = make_seq_mesh(world)
    q, k, v, do = (jnp.asarray(inputs[f"{name}/{n}"])
                   for n in ("q", "k", "v", "do"))
    if dtype is not None:
        q, k, v = (x.astype(dtype) for x in (q, k, v))
    fn = {"ring": ring_attention_sharded,
          "ulysses": ulysses_attention_sharded}[impl](mesh, causal=causal)
    out = fn(q, k, v)
    if not grads:
        return out, None
    g = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32)
                                         * do), argnums=(0, 1, 2))(q, k, v)
    return out, g


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_matches_jax_and_reference(ranks, impl, causal):
    world, inputs, results = ranks
    name = f"{impl}_{'causal' if causal else 'full'}"
    want, _ = _jax(world, inputs, name, impl, causal)
    got = results[0][name]["out"]
    np.testing.assert_allclose(got, np.asarray(want), **F32)
    q, k, v = (jnp.asarray(inputs[f"{name}/{n}"]) for n in "qkv")
    np.testing.assert_allclose(
        got, np.asarray(reference_attention(q, k, v, causal=causal)), **F32)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_flash_kernel_path(ranks, causal):
    # seq/n = 128: every block is one kernel tile, so the ring runs the
    # flash kernel's plain version with the LSE merge (b=2, h=2 pin the
    # flat [B*H, S] LSE layout against its reshape).
    world, inputs, results = ranks
    name = f"ring_tile_{'causal' if causal else 'full'}"
    want, _ = _jax(world, inputs, name, "ring", causal)
    np.testing.assert_allclose(results[0][name]["out"], np.asarray(want),
                               **F32)


def test_ring_bf16_inputs(ranks):
    world, inputs, results = ranks
    want, _ = _jax(world, inputs, "ring_bf16", "ring", False,
                   dtype=jnp.bfloat16)
    res = results[0]["ring_bf16"]
    assert res["dtype"] == "torch.bfloat16"
    np.testing.assert_allclose(res["out"], np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name,impl", [("ring_tile_grads", "ring"),
                                       ("ring_grads", "ring"),
                                       ("ulysses_tile", "ulysses")])
def test_gradients_match_jax(ranks, name, impl):
    # The kernel-tile ring's backward runs K4/K5's plain versions with an
    # LSE cotangent, behind ppermute backwards that every rank walks in
    # the same order (a causal ring's rank 0 skips every block but its
    # own and still sends the visiting blocks' gradients home).
    world, inputs, results = ranks
    want, wg = _jax(world, inputs, name, impl, True, grads=True)
    res = results[0][name]
    np.testing.assert_allclose(res["out"], np.asarray(want), **F32)
    for n, w in zip("qkv", wg):
        np.testing.assert_allclose(res[f"d{n}"], np.asarray(w), rtol=2e-4,
                                   atol=2e-4, err_msg=f"d{n}")


def test_every_rank_gets_the_whole_result(ranks):
    world, _, results = ranks
    assert [r["meta"]["backend"] for r in results] == ["gloo"] * world
    assert all(r["meta"]["device"] == "cpu" for r in results)
    # Only rank 0 writes the whole (replicated) arrays; every rank ran.
    assert all("ring_causal" in r for r in results)
    ring = results[0]["meta"]["cases"]["ring_causal"]["transport"]
    assert ring["ppermute"]["calls"] == world - 1
    assert not results[0]["meta"]["cases"]["ring_causal"]["staged"]


def test_collectives_match_jax_lax(ranks):
    # ppermute (a ring, and a partial permutation whose unsent ranks get
    # zeros) and tiled all_to_all against jax.lax's inside shard_map.
    from jax.sharding import PartitionSpec as P

    from nvshare_tpu.parallel.ring_attention import shard_map

    world, _, results = ranks
    mesh = make_seq_mesh(world)
    x = np.arange(world * 4 * 6, dtype=np.float32).reshape(world * 4, 6)
    perm = [(0, world - 1), (1, 0)]

    def body(x):
        ring = jax.lax.ppermute(x, "seq", [(i, (i + 1) % world)
                                           for i in range(world)])
        part = jax.lax.ppermute(x, "seq", perm)
        return ring, part

    ring, part = shard_map(lambda x: body(x)[:2], mesh=mesh,
                           in_specs=P("seq"),
                           out_specs=(P("seq"), P("seq")))(x)
    got_ring = np.concatenate([r["collectives"]["ring"] for r in results])
    got_part = np.concatenate([r["collectives"]["part"] for r in results])
    np.testing.assert_array_equal(got_ring, np.asarray(ring))
    np.testing.assert_array_equal(got_part, np.asarray(part))
    # all_to_all: [4w, 8] split on dim 1 into w parts, concatenated on 0.
    xa = np.arange(world * 4 * 8, dtype=np.float32).reshape(world * 4, 8)

    def body2(x):
        return jax.lax.all_to_all(x, "seq", split_axis=1, concat_axis=0,
                                  tiled=True)

    a2a = shard_map(body2, mesh=mesh, in_specs=P("seq"),
                    out_specs=P("seq"))(xa)
    got = np.concatenate([r["collectives"]["a2a"] for r in results])
    np.testing.assert_array_equal(got, np.asarray(a2a))
    # The backward of each is its inverse: grads of sum(y * w) come home.
    for r in results:
        np.testing.assert_array_equal(r["collectives"]["a2a_grad"],
                                      r["collectives"]["a2a_grad_want"])
        np.testing.assert_array_equal(r["collectives"]["ring_grad"],
                                      r["collectives"]["ring_grad_want"])
        # all_reduce_sum's one flat buffer over several tensors.
        np.testing.assert_array_equal(r["collectives"]["summed"],
                                      r["collectives"]["summed_want"])


def test_backend_rule():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert collectives.choose_backend(4, cpu, 0) == "gloo"
    assert collectives.choose_backend(1, cuda, 1) == "nccl"
    assert collectives.choose_backend(4, cuda, 4) == "nccl"
    assert collectives.choose_backend(2, cuda, 1) == "gloo"  # one card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        collectives.choose_backend(2, cuda, 0)
    with pytest.raises(ValueError):
        collectives.choose_backend(2, torch.device("meta"), 1)
    with pytest.raises(ValueError):
        collectives.choose_backend(0, cpu, 0)


def test_ring_under_the_gate(tmp_path, native_build):
    # The port's counterpart of test_ring_attention.py's gated ring: two
    # ranks, each a tenant of ONE private scheduler (TQ 1 s, lease grace
    # 30 s), TPUSHARE_FORCE_MULTIHOST=1 so the guard gates a
    # multi-process program. A rank that holds the lock while it waits in
    # a collective hands it on only by its quantum's end or the client's
    # idle release; the ring must finish and equal the ungated one.
    world = 2
    shape = (BATCH, SEQ, HEADS, DIM)
    q, k, v, do = _qkv(3, shape)
    inputs = {f"g/{n}": a for n, a in zip(("q", "k", "v", "do"),
                                          (q, k, v, do))}
    case = dict(case="gated_attention", impl="ring", causal=True,
                grads=True, qkv="g")
    sched = SchedulerProc(tmp_path, tq_sec=1,
                          extra_env={"TPUSHARE_REVOKE_GRACE_S": "30"})
    try:
        res = dryrun.spawn(
            world, [dict(case, name="plain", case="attention"),
                    dict(case, name="gated")],
            device="cpu", inputs=inputs, timeout_s=240,
            env={"TPUSHARE_SOCK_DIR": sched.sock_dir,
                 "TPUSHARE_FORCE_MULTIHOST": "1",
                 "TPUSHARE_PURE_PYTHON": "1"})
        stats = sched.ctl("-s").stdout
    finally:
        log = sched.stop()
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_array_equal(res[0]["gated"][key],
                                      res[0]["plain"][key], err_msg=key)
    for r in res:
        counts = json.loads(r["gated"]["lock_counts"])
        acquires = sum(v for k, v in counts.items() if "acquires" in k)
        assert acquires >= 1, counts
    assert "grants=" in stats, (stats, log[-2000:])
