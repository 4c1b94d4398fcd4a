"""The port's mesh and dp x tp MLP step against the JAX package's, and the
dry run of every axis.

``sharded_mlp_step`` runs as gloo ranks on the CPU (world 2: a 2 x 1
grid; world 4: 2 x 2, so the ``model`` axis is really sharded). Three
steps from parameters carried across from JAX's ``MLP.init`` must equal
the port's single-process ``train_step`` (the same products, cut into
column shards: f32 summation order apart, 2e-5) and JAX's
``sharded_mlp_step`` on the same mesh shape within the MLP tests'
cross-package tolerances (loss 2e-3 relative; state 1e-5: a step moves it
by lr x momentum).
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nvshare_tpu.models import mlp as jmlp
from nvshare_tpu.parallel import make_mesh as jmake_mesh
from nvshare_tpu.parallel import sharded_mlp_step as jsharded_mlp_step
from nvshare_tpu_torch.parallel import dryrun, make_mesh
from tests.conftest import REPO_ROOT

SMALL = dict(in_dim=64, hidden_dim=128, out_dim=32, depth=3)
BATCH, STEPS = 32, 3


@functools.lru_cache(maxsize=None)
def _params():
    return {k: np.asarray(v) for k, v in jmlp.MLP(**SMALL).init(4).items()}


@functools.lru_cache(maxsize=None)
def _ranks(world):
    inputs = {f"p/{k}": v for k, v in _params().items()}
    base = dict(model=SMALL, batch=BATCH, steps=STEPS, params="p", seed=0)
    cases = [dict(base, name="tp", case="mlp"),
             dict(base, name="own", case="mlp", params=None),
             dict(base, name="single", case="mlp_single", params=None)]
    return dryrun.spawn(world, cases, device="cpu", inputs=inputs,
                        timeout_s=240)


def _assemble(res, key, case="tp"):
    """The whole tensor from the ranks' shards (w: columns over model,
    b: entries over model; replicated over data)."""
    shape = tuple(int(s) for s in res[0][case]["shape"])
    row = [r for r in res if int(r[case]["coords"][0]) == 0]
    row.sort(key=lambda r: int(r[case]["coords"][1]))
    dim = 1 if key.startswith("w") else 0
    assert len(row) == shape[1]
    return np.concatenate([r[case][f"params/{key}"] for r in row], axis=dim)


@pytest.mark.parametrize("world,shape", [(2, (2, 1)), (4, (2, 2))])
def test_make_mesh_shape_matches_jax(world, shape):
    res = _ranks(world)
    assert tuple(int(s) for s in res[0]["tp"]["shape"]) == shape
    assert jmake_mesh(world).devices.shape == shape
    coords = sorted(tuple(int(c) for c in r["tp"]["coords"]) for r in res)
    assert coords == [(d, m) for d in range(shape[0])
                      for m in range(shape[1])]


@pytest.mark.parametrize("world", [2, 4])
def test_dp_tp_step_matches_single_process_and_jax(world):
    res = _ranks(world)
    jm = jmlp.MLP(**SMALL)
    mesh = jmake_mesh(world)
    x, y = jmlp.synthetic_batch(jm, BATCH, 0)
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nvshare_tpu.parallel.mesh import _param_spec

    p = {k: jax.device_put(v, NamedSharding(mesh, _param_spec(k)))
         for k, v in params.items()}
    o = {"m": {k: jnp.zeros_like(v) for k, v in p.items()}}
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    ys = jax.device_put(jnp.asarray(y), NamedSharding(mesh, P("data")))
    step = jsharded_mlp_step(mesh, jm)
    want = []
    with mesh:
        for _ in range(STEPS):
            p, o, loss = step(p, o, xs, ys)
            want.append(float(loss))
    got = res[0]["tp"]["losses"]
    np.testing.assert_allclose(got, want, rtol=2e-3)
    for r in res[1:]:
        np.testing.assert_array_equal(r["tp"]["losses"], got)
    for k in params:
        np.testing.assert_allclose(_assemble(res, k), np.asarray(p[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_tp_step_matches_port_train_step(world):
    # The same seed-0 draw on both sides: the ranks cut it into shards,
    # the single process steps the whole of it.
    res = _ranks(world)
    single = res[0]["single"]
    np.testing.assert_allclose(res[0]["own"]["losses"], single["losses"],
                               rtol=2e-5)
    for k in _params():
        np.testing.assert_allclose(_assemble(res, k, "own"),
                                   single[f"params/{k}"], rtol=2e-5,
                                   atol=2e-5, err_msg=k)


def test_make_mesh_refuses_too_few_ranks():
    with pytest.raises(ValueError, match="requested 8 ranks, have 1"):
        make_mesh(8, device="cpu")
    mesh = make_mesh(device="cpu")
    assert mesh.shape == (1, 1) and mesh.axis_names == ("data", "model")


def test_dryrun_entry_point_certifies_every_axis():
    out = subprocess.run(
        [sys.executable, "-m", "nvshare_tpu_torch.parallel.dryrun",
         "--world", "2", "--device", "cpu", "--timeout", "200"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun(2): OK, backend=gloo"), line
    for axis in ("ring_attention=exact", "ulysses=exact", "ep_moe=exact",
                 "pp_gpipe_train_step=ok", "sp+ep_moe_lm_step=ok",
                 "dp_x_sp_step=ok", "seq_sharded_lm_step=ok"):
        assert axis in line, line


def test_spawn_raises_a_rank_failure_with_every_ranks_output():
    """A case that raises in the ranks (experts that do not divide over
    them) fails the spawn: nothing is swallowed, and the failure carries
    each rank's whole output."""
    with pytest.raises(dryrun.RankFailure) as info:
        dryrun.spawn(2, [dict(name="bad", case="moe_ffn", experts=3, d=8,
                              hidden=16, tokens=8)], device="cpu",
                     timeout_s=120)
    assert sorted(info.value.logs) == [0, 1]
    for text in info.value.logs.values():
        assert "ValueError: 3 experts do not divide" in text, text[-2000:]
