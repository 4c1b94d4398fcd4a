"""Flash attention, forward and backward, over [B, S, H, D] inputs.

The port of ``nvshare_tpu/ops/attention.py``. The reference's eligibility
rule is kept: ``seq % 128 == 0`` and ``d <= 128`` take a kernel, anything
else takes :func:`reference_attention` on any device, as the JAX wrapper
does. Among eligible shapes, :func:`kernel_route` chooses by declared dtype
and width, never by trying one and falling back:

- ``"wgmma+tma"``: bf16 with ``d`` in {64, 128}. The forward (K3,
  ``csrc/attention_sm90.cu``), the dQ sweep (K4) and the dK/dV sweep (K5,
  both ``csrc/attention_bwd_sm90.cu``) are Hopper tensor-core kernels:
  TMA loads into a ring of shared-memory stages, ``wgmma`` products of
  bf16 into f32. They round the probabilities P (K3, K5) and dS (K4, K5)
  to bf16 before their products, where the plain versions stay in f32.
- ``"tf32x3"``: f32, and bf16 of any other ``d <= 128`` (staged as it
  lies, read as f32). The forward (``csrc/attention.cu``), K4 and K5 (both
  ``csrc/attention_bwd.cu``) multiply on the tensor cores by the 3xTF32
  split (each f32 operand as two TF32 halves, three ``mma.sync`` products
  into f32, ``csrc/tf32x3.cuh``). Softmax, masks and dS stay in f32 on the
  CUDA cores. All three hold the f32 plain versions within 1e-5 tile by
  tile: the split drops each product's small x small term, the sums run
  in another order.

q, k and v are read strided as they lie (a view into a fused qkv
projection needs no copy). On CPU or meta tensors the wrappers run
:func:`flash_attention_reference`, the plain version, whatever the route.
Each wrapper counts its launches in ``.launches`` and, per route, in
``.route_launches``. Under the dispatch-mode gate each wrapper call is one
gated unit (:func:`nvshare_tpu_torch.interpose.launch_unit`).

Both entry points run inside a :class:`torch.autograd.Function`. Its
backward saves q, k, v, the output and the LSE, and recomputes the
probabilities from the LSE in two kernels, each by the route above: the
dQ sweep :func:`flash_backward_dq` (K4) and the dK/dV sweep
:func:`flash_backward_dkv` (K5), one writer per output tile, no
atomics. The LSE output's cotangent folds into dS, so
:func:`flash_attention_lse` is differentiable in both outputs. On CPU or
meta tensors the wrappers run their plain versions (together,
:func:`flash_backward_reference`); the ragged route differentiates
:func:`reference_attention`, as the JAX package does.
"""

from __future__ import annotations

import math

import torch

from nvshare_tpu_torch import interpose
from nvshare_tpu_torch.ops import _build

_BQ = 128
_BK = 128
_NEG_INF = -1e30


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """f32 scores [B, H, Sq, Sk] = q k^T / sqrt(d), -1e30 where masked."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]  # cross-length safe (both from 0)
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        mask = torch.where(keep, 0.0, _NEG_INF)
        s = s + mask[None, None, :, :]
    return s


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Single-device full attention: the port of
    ``nvshare_tpu.parallel.ring_attention.reference_attention``, the
    route for ragged or oversized shapes."""
    p = torch.softmax(_scores(q, k, causal), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: ``(out [B,Sq,H,D] in
    q.dtype, lse [B*H, Sq] f32)``, with the whole score matrix in f32."""
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)                        # [B, H, Sq]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    b, h, sq = lse.shape
    return out, lse.reshape(b * h, sq)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, [B*H, S]: the softmax Jacobian's row
    term of the backward (O(S*D) elementwise, outside the kernels as in
    the JAX package)."""
    b, s, h, _ = o.shape
    delta = (do.float() * o.float()).sum(dim=-1)            # [B, S, H]
    return delta.transpose(1, 2).reshape(b * h, s)


def _probs_and_ds(q, k, v, do, lse, delta, causal: bool, g_lse) -> tuple:
    """(p, dS) [B, H, Sq, Sk] in f32, the whole score matrix at once: p
    recomputed from the saved ``lse`` [B*H, Sq], dP = dO v^T, dS = p (dP -
    delta + g_lse) / sqrt(d)."""
    b, sq, h, d = q.shape
    rows = (b, h, sq, 1)
    s = _scores(q, k, causal)                    # -1e30 where masked
    p = torch.exp(s - lse.reshape(rows))         # masked entries: exactly 0
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    row = delta if g_lse is None else delta - g_lse
    return p, p * (dp - row.reshape(rows)) * (1.0 / math.sqrt(d))


def flash_backward_dq_reference(q, k, v, do, lse, delta,
                                causal: bool = False, g_lse=None
                                ) -> torch.Tensor:
    """K4's plain version: dQ = dS k in q's type."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, g_lse)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_backward_dkv_reference(q, k, v, do, lse, delta,
                                 causal: bool = False, g_lse=None
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: dK = dS^T q and dV = p^T dO in k's and v's
    types."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, g_lse)
    return (torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(k.dtype),
            torch.einsum("bhqk,bqhd->bkhd", p, do.float()).to(v.dtype))


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor,
                             lse: torch.Tensor, delta: torch.Tensor,
                             causal: bool = False,
                             g_lse: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, ...]:
    """The plain PyTorch version of the backward kernels: ``(dq, dk, dv)``
    in q's, k's and v's types, with the whole score matrix in f32."""
    args = (q, k, v, do, lse, delta, causal, g_lse)
    return (flash_backward_dq_reference(*args),
            *flash_backward_dkv_reference(*args))


def _kernel_shapes_ok(sq: int, sk: int, d: int) -> bool:
    return not (sq % _BQ or sk % _BK or d > 128)


WGMMA = "wgmma+tma"
TF32X3 = "tf32x3"
REFERENCE = "reference"


def kernel_route(q: torch.Tensor, k: torch.Tensor) -> str:
    """The route of flash attention (K3, and K4 and K5 in the backward)
    for q [B,Sq,H,D] and k [B,Sk,H,D], by declared shape and dtype: REFERENCE
    for ragged or oversized shapes, WGMMA for bf16 with d in {64, 128},
    TF32X3 for every other eligible shape (f32, or bf16 of another width),
    whose K3, K4 and K5 run on the tensor cores by the 3xTF32 split. On a
    CPU or meta tensor it names the route a CUDA tensor of the same shape
    and dtype takes."""
    d = q.shape[-1]
    if not _kernel_shapes_ok(q.shape[1], k.shape[1], d):
        return REFERENCE
    if q.dtype == torch.bfloat16 and d in (64, 128):
        return WGMMA
    return TF32X3


def _route_counts() -> dict:
    return {WGMMA: _build.LaunchCount(), TF32X3: _build.LaunchCount()}


def _strided(x: torch.Tensor) -> torch.Tensor:
    """x as the 3xTF32 kernels read it: rows and heads strided, the head
    dimension contiguous."""
    return x if x.stride(-1) == 1 else x.contiguous()


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """x as the wgmma kernels read it: TMA takes any strides that are
    multiples of 16 bytes from a 16-byte-aligned base (the views of the
    fused qkv projection are), so x is copied only where that fails."""
    ok = x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
        st * x.element_size() % 16 == 0 for st in x.stride()[:-1])
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def _strides(*xs: torch.Tensor) -> list:
    return [st for x in xs for st in x.stride()[:3]]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Run K3 by its route (eligible shapes, CUDA tensors)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"flash attention takes q [B,Sq,H,D] and k, v "
                         f"[B,Sk,H,D]; got q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if not (q.device == k.device == v.device) or \
            not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash attention kernel takes q, k and v of one "
                        "dtype on one device")
    code = _build.dtype_code(q.dtype, "flash_attention")
    route = kernel_route(q, k)
    if route == WGMMA:
        fn = _build.load("attention_sm90").tpushare_flash_forward_sm90
        q, k, v = (_tma_ready(x) for x in (q, k, v))
    else:
        fn = _build.load("attention").tpushare_flash_forward
        q, k, v = (_strided(x) for x in (q, k, v))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, h, sq, sk, d, *_strides(q, k, v),
                int(causal), code, 1.0 / math.sqrt(d), stream)
    _build.check(rc, f"flash_attention ({route})")
    flash_attention.launches.add()
    flash_attention.route_launches[route].add()
    return out, lse


def _forward(q, k, v, causal: bool):
    """(out, lse) through the kernel, or (out, None) on the ragged route."""
    if not _kernel_shapes_ok(q.shape[1], k.shape[1], q.shape[-1]):
        return reference_attention(q, k, v, causal=causal), None
    with interpose.launch_unit(q.device):
        if q.device.type != "cuda":
            return flash_attention_reference(q, k, v, causal=causal)
        return _launch(q, k, v, causal)


def _launch_backward(which: str, q, k, v, do, lse, delta, g_lse,
                     causal: bool):
    """Run K4 (``which="dq"``) or K5 (``"dkv"``) on CUDA tensors of
    eligible shapes; returns the kernel's outputs."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != k.shape or \
            do.shape != q.shape:
        raise ValueError(f"flash backward takes q, dO [B,Sq,H,D] and k, v "
                         f"[B,Sk,H,D]; got q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"dO{tuple(do.shape)}")
    rows = [x for x in (lse, delta, g_lse) if x is not None]
    if not (q.device == k.device == v.device == do.device) or \
            any(x.device != q.device for x in rows) or \
            not (q.dtype == k.dtype == v.dtype == do.dtype):
        raise TypeError("flash backward kernels take q, k, v and dO of one "
                        "dtype, and the row terms, on one device")
    if any(x.dtype != torch.float32 or x.shape != (b * h, sq)
           for x in rows):
        raise ValueError(f"lse, delta and g_lse must be float32 "
                         f"[{b * h}, {sq}]")
    code = _build.dtype_code(q.dtype, "flash backward")
    route = kernel_route(q, k)
    if route == WGMMA:
        q, k, v, do = (_tma_ready(x) for x in (q, k, v, do))
    else:
        q, k, v, do = (_strided(x) for x in (q, k, v, do))
    lse, delta = lse.contiguous(), delta.contiguous()
    g_lse = None if g_lse is None else g_lse.contiguous()
    n_out, seq = (1, sq) if which == "dq" else (2, sk)
    outs = tuple(torch.empty((b, seq, h, d), dtype=q.dtype,
                             device=q.device) for _ in range(n_out))
    suffix = "_sm90" if route == WGMMA else ""
    fn = getattr(_build.load(f"attention_bwd{suffix}"),
                 f"tpushare_flash_backward_{which}{suffix}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(),
                None if g_lse is None else g_lse.data_ptr(),
                *(o.data_ptr() for o in outs), b, h, sq, sk, d,
                *_strides(q, k, v, do), int(causal), code,
                1.0 / math.sqrt(d), stream)
    _build.check(rc, f"flash backward ({which}, {route})")
    return outs, route


def flash_backward_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, causal: bool = False,
                      g_lse: torch.Tensor | None = None) -> torch.Tensor:
    """dQ [B,Sq,H,D] in q's type: K4 on a CUDA tensor, by
    :func:`kernel_route`, the plain version
    (:func:`flash_backward_dq_reference`) on a CPU or meta tensor.
    Kernel-eligible shapes only."""
    with interpose.launch_unit(q.device):
        if q.device.type != "cuda":
            return flash_backward_dq_reference(q, k, v, do, lse, delta,
                                               causal, g_lse)
        (dq,), route = _launch_backward("dq", q, k, v, do, lse, delta,
                                        g_lse, causal)
        flash_backward_dq.launches.add()
        flash_backward_dq.route_launches[route].add()
    return dq


def flash_backward_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, causal: bool = False,
                       g_lse: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B,Sk,H,D] in k's and v's types: K5 on a CUDA tensor, by
    :func:`kernel_route`, the plain version on a CPU or meta tensor.
    Kernel-eligible shapes only."""
    with interpose.launch_unit(q.device):
        if q.device.type != "cuda":
            return flash_backward_dkv_reference(q, k, v, do, lse, delta,
                                                causal, g_lse)
        (dk, dv), route = _launch_backward("dkv", q, k, v, do, lse, delta,
                                           g_lse, causal)
        flash_backward_dkv.launches.add()
        flash_backward_dkv.route_launches[route].add()
    return dk, dv


flash_backward_dq.launches = _build.LaunchCount()
flash_backward_dq.route_launches = _route_counts()
flash_backward_dkv.launches = _build.LaunchCount()
flash_backward_dkv.route_launches = _route_counts()


def _flash_backward(q, k, v, o, lse, g, causal: bool, g_lse=None):
    """(dq, dk, dv) of the kernel route: delta, then K4 and K5 (their
    plain versions on CPU or meta tensors)."""
    delta = attention_delta(o, g)
    dq = flash_backward_dq(q, k, v, g, lse, delta, causal, g_lse)
    dk, dv = flash_backward_dkv(q, k, v, g, lse, delta, causal, g_lse)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernel forward, and a backward through K4 and K5 (or, on the
    ragged route, through the oracle's own autograd)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, with_lse: bool):
        out, lse = _forward(q, k, v, causal)
        ctx.causal = causal
        if lse is None:   # ragged: the backward re-runs the oracle
            ctx.save_for_backward(q, k, v)
        else:
            ctx.save_for_backward(q, k, v, out, lse)
        return (out, lse) if with_lse else out

    @staticmethod
    def backward(ctx, g, g_lse=None):
        saved = ctx.saved_tensors
        if len(saved) == 3:
            with torch.enable_grad():
                prim = [x.detach().requires_grad_() for x in saved]
                out = reference_attention(*prim, causal=ctx.causal)
                grads = torch.autograd.grad(out, prim, g)
        else:
            grads = _flash_backward(*saved, g, ctx.causal, g_lse)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Exact attention for [batch, seq, heads, dim] inputs.

    Shapes with seq % 128 == 0 and dim <= 128 take K3 by
    :func:`kernel_route` (on a CUDA tensor) or its plain version (on a CPU
    or meta tensor); anything else
    takes :func:`reference_attention` (same math). Differentiable: the
    backward runs K4 and K5 (or their plain version on the CPU).
    """
    return _FlashAttention.apply(q, k, v, causal, False)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns the per-row log-sum-exp:
    ``(out [B,S,H,D], lse [B*H, S] f32)``. Kernel-eligible shapes only
    (seq % 128 == 0, dim <= 128): the ragged route has no LSE.
    Differentiable in both outputs: the LSE's cotangent folds into dS."""
    if not _kernel_shapes_ok(q.shape[1], k.shape[1], q.shape[-1]):
        raise ValueError(
            f"flash_attention_lse requires kernel-eligible shapes "
            f"(seq%{_BQ}==0, dim<=128); got q{tuple(q.shape)} "
            f"k{tuple(k.shape)}")
    return _FlashAttention.apply(q, k, v, causal, True)


# One count for both entry points: each launch of K3 adds one, to the total
# and to its route's.
flash_attention.launches = _build.LaunchCount()
flash_attention.route_launches = _route_counts()
flash_attention_lse.launches = flash_attention.launches
flash_attention_lse.route_launches = flash_attention.route_launches
