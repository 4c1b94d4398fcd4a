"""The port's input pipeline against the JAX package's.

The counterpart of ``tests/test_data_pipeline.py`` on the CPU (where
``prefetch_to_device`` is the plain deque; the card's pinned buffers and
side stream run in ``chip_smoke.py``'s unmodified pair): order and
exhaustion as the reference yields them, ``size`` below 1 refused,
training from the prefetched stream equal to training from the direct
stream, and the token stream equal to the reference's bit for bit.
"""

import numpy as np
import pytest
import torch

from nvshare_tpu.models.transformer import Transformer as RefTransformer
from nvshare_tpu.utils import data as ref
from nvshare_tpu_torch.models import mlp
from nvshare_tpu_torch.models.transformer import Transformer
from nvshare_tpu_torch.utils.data import (
    prefetch_to_device,
    synthetic_token_batches,
)


@pytest.mark.parametrize("size", [1, 3, 10])
def test_prefetch_preserves_order_and_exhausts(size):
    batches = [(np.full((4,), i, np.int32), {"y": np.arange(i, i + 2)})
               for i in range(7)]
    out = list(prefetch_to_device(iter(batches), size=size, device="cpu"))
    want = list(ref.prefetch_to_device(iter(batches), size=size))
    assert len(out) == len(want) == 7
    for got, (wx, wy) in zip(out, want):
        assert isinstance(got, tuple) and isinstance(got[0], torch.Tensor)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(wx))
        np.testing.assert_array_equal(got[1]["y"].numpy(),
                                      np.asarray(wy["y"]))


@pytest.mark.parametrize("size", [0, -1])
def test_prefetch_rejects_size_below_one(size):
    with pytest.raises(ValueError):
        next(prefetch_to_device(iter([np.zeros(2)]), size=size,
                                device="cpu"))
    with pytest.raises(ValueError):
        next(ref.prefetch_to_device(iter([np.zeros(2)]), size=size))


def test_prefetch_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(prefetch_to_device(iter([np.zeros(2)])))


def test_training_from_prefetched_stream_equals_direct():
    model = mlp.MLP(in_dim=64, hidden_dim=128, out_dim=16, depth=3)

    def run(stream):
        params, opt = mlp.init_train_state(model, seed=0, device="cpu")
        losses = []
        for x, y in stream:
            params, opt, loss = mlp.train_step(params, opt, x, y)
            losses.append(float(loss))
        return losses, params

    batches = [mlp.synthetic_batch(model, 16, seed=i) for i in range(6)]
    direct = run((torch.from_numpy(x), torch.from_numpy(y))
                 for x, y in batches)
    fetched = run(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert direct[0] == fetched[0]
    assert len(fetched[0]) == 6 and all(np.isfinite(fetched[0]))
    for name in direct[1]:
        assert torch.equal(direct[1][name], fetched[1][name]), name


def test_synthetic_token_batches_match_reference():
    kw = dict(vocab=64, dim=32, heads=4, depth=1, seq=64)
    got = list(synthetic_token_batches(Transformer(**kw), batch=3,
                                       n_batches=4, seed=2))
    want = list(ref.synthetic_token_batches(RefTransformer(**kw), batch=3,
                                            n_batches=4, seed=2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
