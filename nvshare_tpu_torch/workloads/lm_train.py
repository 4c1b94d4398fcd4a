"""An unmodified LM training program:

    python -m nvshare_tpu_torch.workloads.lm_train [--layers 16]
        [--steps 8] [--batch 4] [--seed 0] [--name lm] [--device cuda]

Trains the port's :class:`~nvshare_tpu_torch.models.transformer.Transformer`
at GPT-3 6.7B widths (d_model 4096, 32 heads of 128, vocabulary 50257,
2048 positions; the depth is an argument), every block recomputed in the
backward, with momentum SGD (lr 1e-2) on batches of 4 x 2048 tokens from
the synthetic corpus, on plain tensors: nothing pages. Its one tpushare
line is ``import nvshare_tpu_torch.autoload``; ``TPUSHARE_DISABLE=1``
runs it ungated. Prints ``<name> loss <step> <loss>`` a step and a RESULT
line (:func:`nvshare_tpu_torch.workloads.result_line`).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def run(model, *, steps: int, batch: int, seed: int = 0,
        lr: float = 1e-2, device=None, name: str = "lm") -> None:
    """Train ``model`` from seed ``seed`` for ``steps`` steps of
    ``batch`` sequences, printing each loss and the RESULT line."""
    # Deterministic cuBLAS: a pair's results must equal solo bit for bit.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    from nvshare_tpu_torch.device import resolve_device
    from nvshare_tpu_torch.models.transformer import (
        init_lm_state,
        lm_train_step,
        synthetic_tokens,
    )
    from nvshare_tpu_torch.workloads import result_line, state_sum

    dev = resolve_device(device)
    t_begin = time.time()
    params, opt = init_lm_state(model, seed=seed, device=dev)
    losses, step_s = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        toks = torch.from_numpy(synthetic_tokens(
            model, batch, seed=seed * 100003 + i)).to(dev)
        params, opt, loss = lm_train_step(params, opt, toks, model, lr=lr)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
        print(f"{name} loss {i} {losses[-1]!r}", flush=True)
    print(result_line(name, dev, losses=losses,
                      state_sum=state_sum(params, opt), step_s=step_s,
                      t_begin=t_begin, t_end=time.time(),
                      layers=model.depth, steps=steps), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nvshare_tpu_torch.workloads.lm_train")
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--name", default="lm")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu only when asked for")
    args = ap.parse_args(argv)
    from nvshare_tpu_torch.models.transformer import Transformer

    model = Transformer(vocab=50257, dim=4096, heads=32, depth=args.layers,
                        seq=2048, remat=True)
    run(model, steps=args.steps, batch=args.batch, seed=args.seed,
        device=args.device, name=args.name)
    return 0


if __name__ == "__main__":
    import nvshare_tpu_torch.autoload  # noqa: F401  (the one tpushare line)

    sys.exit(main())
