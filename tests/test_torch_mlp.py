"""The port's MLP against the JAX package's.

``synthetic_batch`` draws the same numpy batch bit for bit. On parameters
carried across by ``convert.mlp_params_from_numpy``, the logits, the
loss and three momentum-SGD train steps (losses, parameters, momentum)
agree with ``nvshare_tpu.models.mlp`` within bf16 tolerances: both
compute in bf16 with f32 accumulation, so a product's f32 result may
differ in summation order, and a hidden activation rounded to bf16
(unit roundoff 2**-8) may then land one bf16 step apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvshare_tpu.models import mlp as ref
from nvshare_tpu_torch.convert import mlp_params_from_numpy
from nvshare_tpu_torch.models import mlp

SMALL = dict(in_dim=64, hidden_dim=128, out_dim=16, depth=3)
BATCH = 32
LOGIT_TOL = 1e-2   # of max |logit|: a few bf16 steps through 3 layers
LOSS_RTOL = 2e-3
STATE_RTOL = 1e-5  # a step moves the state by lr * m, 1e-3 of it


def _pair(seed=0):
    jparams = ref.MLP(**SMALL).init(seed)
    nparams = {k: np.asarray(v) for k, v in jparams.items()}
    return jparams, mlp_params_from_numpy(nparams, device="cpu")


@pytest.mark.parametrize("seed,batch", [(0, 32), (7, 5), (123, 256)])
def test_synthetic_batch_bit_for_bit(seed, batch):
    x, y = mlp.synthetic_batch(mlp.MLP(), batch, seed=seed)
    rx, ry = ref.synthetic_batch(ref.MLP(), batch, seed=seed)
    assert x.dtype == rx.dtype and y.dtype == ry.dtype
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)


def test_init_shapes_and_scales():
    model = mlp.MLP(**SMALL)
    params = model.init(seed=0, device="cpu")
    want = ref.MLP(**SMALL).init(0)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in params.values())
    # He-normal: std sqrt(2 / fan_in), within sampling error.
    std = float(params["w0"].std())
    assert abs(std - (2.0 / SMALL["in_dim"]) ** 0.5) < 0.05 * std
    assert all(float(params[f"b{i}"].abs().sum()) == 0.0 for i in range(3))


def test_logits_and_loss_match_jax():
    jparams, tparams = _pair()
    x, y = ref.synthetic_batch(ref.MLP(**SMALL), BATCH, seed=3)
    want = np.asarray(ref.mlp_forward(jparams, jnp.asarray(x)))
    got = mlp.mlp_forward(tparams, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())
    want_loss = float(ref._loss(jparams, jnp.asarray(x), jnp.asarray(y)))
    got_loss = float(mlp.mlp_loss(tparams, torch.from_numpy(x),
                                  torch.from_numpy(y)))
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)


def test_three_train_steps_match_jax():
    jparams, tparams = _pair(seed=1)
    jopt = {"m": jax.tree_util.tree_map(jnp.zeros_like, jparams)}
    topt = {"m": {k: torch.zeros_like(v) for k, v in tparams.items()}}
    model = ref.MLP(**SMALL)
    for step in range(3):
        x, y = ref.synthetic_batch(model, BATCH, seed=10 + step)
        jparams, jopt, jloss = ref.train_step(
            jparams, jopt, jnp.asarray(x), jnp.asarray(y))
        tparams, topt, tloss = mlp.train_step(
            tparams, topt, torch.from_numpy(x), torch.from_numpy(y))
        assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    for name in jparams:
        np.testing.assert_allclose(
            tparams[name].numpy(), np.asarray(jparams[name]),
            rtol=STATE_RTOL, atol=STATE_RTOL)
        m = np.asarray(jopt["m"][name])
        # The momentum is a sum of gradients: bf16-computed, so held at
        # the logits' tolerance of its own scale.
        np.testing.assert_allclose(topt["m"][name].numpy(), m, rtol=0,
                                   atol=LOGIT_TOL * max(np.abs(m).max(),
                                                        1e-6))


def test_train_state_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mlp.init_train_state(mlp.MLP(**SMALL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mlp_params_from_numpy({"b0": np.zeros(4, np.float32)})
    params, opt = mlp.init_train_state(mlp.MLP(**SMALL), device="cpu")
    assert params["w0"].device.type == opt["m"]["w0"].device.type == "cpu"
