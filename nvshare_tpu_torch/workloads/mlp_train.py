"""An unmodified MLP training program with an input pipeline and a
checkpoint:

    python -m nvshare_tpu_torch.workloads.mlp_train [--steps 200]
        [--batch 4096] [--seed 0] [--ckpt DIR] [--resume DIR]
        [--name mlp] [--device cuda]

Trains the port's :class:`~nvshare_tpu_torch.models.mlp.MLP` at its
default widths (1024 -> 4096 x 3 -> 256) with momentum SGD (lr 1e-3) on a
fresh :func:`~nvshare_tpu_torch.models.mlp.synthetic_batch` a step, fed
through :func:`~nvshare_tpu_torch.utils.data.prefetch_to_device`.
``--ckpt DIR`` saves the train state at the midpoint as
``DIR/step_<n>``; ``--resume DIR`` restores the latest checkpoint there
and trains on from its step, so a resumed run ends where an uninterrupted
one does, bit for bit. Its one tpushare line is ``import
nvshare_tpu_torch.autoload``. Prints ``<name> loss <step> <loss>`` per
step (read back once, at the end, so the pipeline stays ahead) and a
RESULT line (:func:`nvshare_tpu_torch.workloads.result_line`).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def batches(model, batch: int, start: int, stop: int, seed: int):
    """Step ``i``'s batch for ``i`` in [start, stop): the same batch for
    a step whichever run (resumed or not) draws it."""
    from nvshare_tpu_torch.models.mlp import synthetic_batch

    for i in range(start, stop):
        yield synthetic_batch(model, batch, seed=seed * 100003 + i)


def run(model, *, steps: int, batch: int, seed: int = 0,
        lr: float = 1e-3, ckpt=None, resume=None, device=None,
        name: str = "mlp") -> None:
    """Train ``model`` for ``steps`` steps (from the checkpoint under
    ``resume`` when given; saving one under ``ckpt`` at the midpoint),
    printing each loss and the RESULT line."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    from nvshare_tpu_torch.device import resolve_device
    from nvshare_tpu_torch.models.mlp import init_train_state, train_step
    from nvshare_tpu_torch.utils.checkpoint import (
        latest_step_dir,
        restore_train_state,
        save_train_state,
    )
    from nvshare_tpu_torch.utils.data import prefetch_to_device
    from nvshare_tpu_torch.workloads import result_line, state_sum

    dev = resolve_device(device)
    t_begin = time.time()
    params, opt = init_train_state(model, seed=seed, device=dev)
    start = 0
    if resume is not None:
        path = latest_step_dir(resume)
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {resume}")
        params, opt, start = restore_train_state(path, params, opt)
    mid = steps // 2
    losses = []
    t0 = time.perf_counter()
    stream = prefetch_to_device(batches(model, batch, start, steps, seed),
                                size=2, device=dev)
    for i, (x, y) in enumerate(stream, start):
        params, opt, loss = train_step(params, opt, x, y, lr=lr)
        losses.append(loss)
        if ckpt is not None and i + 1 == mid:
            save_train_state(os.path.join(ckpt, f"step_{mid}"), params, opt,
                             mid)
    losses = torch.stack(losses).tolist() if losses else []
    run_s = time.perf_counter() - t0
    for i, loss in enumerate(losses, start):
        print(f"{name} loss {i} {loss!r}", flush=True)
    print(result_line(name, dev, losses=losses, start=start,
                      state_sum=state_sum(params, opt), run_s=run_s,
                      t_begin=t_begin, t_end=time.time(), steps=steps,
                      batch=batch), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nvshare_tpu_torch.workloads.mlp_train")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="save the train state here at the midpoint")
    ap.add_argument("--resume", default=None,
                    help="restore the latest checkpoint under this root")
    ap.add_argument("--name", default="mlp")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu only when asked for")
    args = ap.parse_args(argv)
    from nvshare_tpu_torch.models.mlp import MLP

    run(MLP(), steps=args.steps, batch=args.batch, seed=args.seed,
        ckpt=args.ckpt, resume=args.resume, device=args.device,
        name=args.name)
    return 0


if __name__ == "__main__":
    import nvshare_tpu_torch.autoload  # noqa: F401  (the one tpushare line)

    sys.exit(main())
