#!/usr/bin/env python3
"""A/B builds of the f32 attention route's kernels on one card.

    python3 kernel_ab.py DIR [DIR ...]

Each DIR holds a copy of ``nvshare_tpu_torch/csrc`` (``attention.cu``,
``attention_bwd.cu`` and the headers), edited as a variant. Every copy is
built at once by the package's own build (``ops/_build.py``, with
``-Xptxas=-v``: registers and spills are printed), then K3
(``flash_attention_lse``), K4 (``flash_backward_dq``) and K5
(``flash_backward_dkv``) of each run in turns on the same inputs at the
ring's blocks, [4, 1024, 32, 128] f32, causal diagonal and full past, two
rounds: tile-wise error against the plain versions, whether the outputs
equal the first copy's bit for bit, and milliseconds by CUDA events. The
first copy is usually the tree's own ``csrc``. Needs one CUDA card and
``nvcc``; prints the card's name and power limit first.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from nvshare_tpu_torch.ops import _build  # noqa: E402
from nvshare_tpu_torch.ops import attention as tatt  # noqa: E402
from nvshare_tpu_torch.parallel.dryrun import tile_rel_err  # noqa: E402

NAMES = ("attention", "attention_bwd")


def build(dirs) -> None:
    """Every source of every copy compiled at once; the registers and
    spills of each are printed."""
    with ThreadPoolExecutor(len(dirs)) as pool:
        results = list(pool.map(
            lambda d: _build.build(NAMES, ptxas_verbose=True, csrc=d), dirs))
    for d, result in zip(dirs, results):
        for name in NAMES:
            print(d.name, name, [line.split(":", 1)[-1].strip()
                                 for line in result[name]["log"].splitlines()
                                 if "registers" in line or "spill" in line])


def main(argv) -> int:
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    dirs = [Path(a).resolve() for a in argv]
    print(cs.card_line(), flush=True)
    build(dirs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, d = cs.PAR_RING_BLOCK
    for tag, causal in (("causal_diag", True), ("full_past", False)):
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen,
                                   device="cuda").mul_(0.5)
                       for _ in range(4))
        g_lse = torch.randn((b * h, s), generator=gen,
                            device="cuda").mul_(0.5)
        want_o, lse = tatt.flash_attention_reference(q, k, v, causal=causal)
        args = (q, k, v, do, lse, tatt.attention_delta(want_o, do), causal,
                g_lse)
        want = tatt.flash_backward_reference(*args)
        first = None
        for rnd in range(2):
            for dd in dirs:
                _build.use_sources(dd)
                outs = (*tatt.flash_attention_lse(q, k, v, causal=causal),
                        tatt.flash_backward_dq(*args),
                        *tatt.flash_backward_dkv(*args))
                torch.cuda.synchronize()
                first = outs if first is None else first
                # o and lse (K3), dq (K4), dk and dv (K5)
                eq = [torch.equal(x, y) for x, y in zip(outs, first)]
                same = dict(K3=eq[0] and eq[1], K4=eq[2],
                            K5=eq[3] and eq[4])
                errs = [tile_rel_err(outs[0], want_o)] + [
                    tile_rel_err(g, w) for g, w in zip(outs[2:], want)]
                k3 = cs.cuda_ms(lambda: tatt.flash_attention_lse(
                    q, k, v, causal=causal), 10)
                k4 = cs.cuda_ms(lambda: tatt.flash_backward_dq(*args), 10)
                k5 = cs.cuda_ms(lambda: tatt.flash_backward_dkv(*args), 10)
                print(f"{tag} round {rnd} {dd.name}: K3 {k3:.3f} ms, K4 "
                      f"{k4:.3f} ms, K5 {k5:.3f} ms; bits equal to "
                      f"{dirs[0].name}'s: {same}; tile-wise K3 "
                      f"{errs[0]:.3g}, K4 {errs[1]:.3g}, K5 dk "
                      f"{errs[2]:.3g}, dv {errs[3]:.3g}", flush=True)
        del q, k, v, do, args, want, first, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
