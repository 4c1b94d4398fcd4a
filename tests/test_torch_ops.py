"""Parity of the port's ops with the JAX package's on the CPU.

The same seeded numpy inputs go through ``nvshare_tpu.ops`` (Pallas in
interpret mode, as the JAX package's own tests run it) and through
``nvshare_tpu_torch.ops`` on ``device="cpu"``, where the port's wrappers run
their plain PyTorch versions. The CUDA kernels themselves are held against
those plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nvshare_tpu import ops as jops
from nvshare_tpu_torch import ops as tops


def _mix_inputs(seed=0, shape=(512, 768)):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape).astype(np.float32),
            rng.rand(*shape).astype(np.float32))


def test_fused_mix_f32_matches_jax():
    a, b = _mix_inputs()
    want = np.asarray(jops.fused_mix(jnp.asarray(a), jnp.asarray(b)))
    got = tops.fused_mix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    # Both evaluate a*0.5 + b*0.5 + 0.125 in f32; XLA may contract one
    # multiply-add into an FMA, a last-place difference.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_fused_mix_bf16_matches_jax():
    a, b = _mix_inputs(1)
    want = np.asarray(jops.fused_mix(jnp.asarray(a, jnp.bfloat16),
                                     jnp.asarray(b, jnp.bfloat16)),
                      dtype=np.float32)
    got = tops.fused_mix(torch.from_numpy(a).bfloat16(),
                         torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    # bf16 keeps 8 significant bits (relative step 2^-8 ~ 3.9e-3); the two
    # frameworks may round the intermediate sums at different places.
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3)


def test_fused_mix_custom_scalars_and_out():
    a, b = _mix_inputs(2, (256, 256))
    want = np.asarray(jops.fused_mix(jnp.asarray(a), jnp.asarray(b),
                                     alpha=0.25, beta=2.0, bias=-1.0))
    ta = torch.from_numpy(a.copy())
    res = tops.fused_mix(ta, torch.from_numpy(b), 0.25, 2.0, -1.0, out=ta)
    assert res is ta
    np.testing.assert_allclose(ta.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(100, 3), (256, 100), (3, 256, 256)])
def test_fused_mix_ragged_route(shape):
    """Shapes the kernel does not take keep the plain expression, as the
    JAX function leaves them to XLA (tests/test_models.py)."""
    rng = np.random.RandomState(3)
    a = rng.rand(*shape).astype(np.float32)
    want = np.asarray(jops.fused_mix(jnp.asarray(a), jnp.asarray(a)))
    got = tops.fused_mix(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_fused_mix_kernel_launch_count_untouched_on_cpu():
    before = tops.fused_mix.launches.value
    a, b = _mix_inputs(4, (256, 256))
    tops.fused_mix(torch.from_numpy(a), torch.from_numpy(b))
    assert tops.fused_mix.launches.value == before


def test_tiled_matmul_matches_jax():
    rng = np.random.RandomState(3)
    # Multi-tile in every grid dimension (2x1x3 tiles of 128).
    a = rng.rand(256, 384).astype(np.float32)
    b = rng.rand(384, 128).astype(np.float32)
    want = np.asarray(jops.tiled_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = tops.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (256, 128)
    # Identical bf16 operands and exact products; only the order of the
    # f32 sums differs (K = 384 terms near 96: ulp 7.6e-6).
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_tiled_matmul_bf16_in_bf16_out():
    rng = np.random.RandomState(5)
    a = rng.rand(128, 256).astype(np.float32)
    b = rng.rand(256, 128).astype(np.float32)
    want = np.asarray(jops.tiled_matmul(jnp.asarray(a, jnp.bfloat16),
                                        jnp.asarray(b, jnp.bfloat16)),
                      dtype=np.float32)
    got = tops.tiled_matmul(torch.from_numpy(a).bfloat16(),
                            torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    # The f32 sums may differ in their last bits, which can move the final
    # bf16 rounding by one step (2^-8 relative).
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3)


@pytest.mark.parametrize("ma,ka,kb,nb", [(100, 60, 60, 50),
                                         (128, 128, 256, 128),
                                         (256, 200, 200, 128)])
def test_tiled_matmul_ragged_route(ma, ka, kb, nb):
    """Shapes off the 128 grid take the plain bf16 product (the JAX
    function's XLA dot); mismatched inner dimensions raise in both."""
    rng = np.random.RandomState(6)
    a = rng.rand(ma, ka).astype(np.float32)
    b = rng.rand(kb, nb).astype(np.float32)
    if ka != kb:
        with pytest.raises(Exception):
            jops.tiled_matmul(jnp.asarray(a), jnp.asarray(b))
        with pytest.raises(RuntimeError):
            tops.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b))
        return
    want = np.asarray(jops.tiled_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = tops.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_ops_run_on_meta_for_shape_evaluation():
    """vop reserves output bytes by running a function on meta tensors, so
    the wrappers must take meta tensors without launching anything."""
    m = torch.empty(256, 384, device="meta")
    n = torch.empty(384, 128, device="meta")
    assert tops.tiled_matmul(m, n).shape == (256, 128)
    assert tops.fused_mix(m, m, out=m) is m
