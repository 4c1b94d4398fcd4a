"""The port's kernels as the CPU can check them: which route each flash
attention shape takes, and that every C entry point in
``nvshare_tpu_torch/csrc`` is bound by ``ops/_build.py`` with argument
types of the right widths (ctypes passes an ``int`` argument as 32 bits,
so a pointer or a 64-bit stride bound as one is silently cut), and that a
header edit rebuilds the libraries that include it.

The kernels themselves are compiled and held against their plain versions
on the card by ``chip_smoke.py``; nothing here needs ``nvcc``.
"""

import ctypes
import re
import shutil

import numpy as np
import pytest
import torch

from nvshare_tpu_torch.ops import _build
from nvshare_tpu_torch.ops import attention as tatt

ROUTES = {
    # name: (dtype, seq, d, route)
    "bf16_d64": (torch.bfloat16, 256, 64, tatt.WGMMA),
    "bf16_d128": (torch.bfloat16, 256, 128, tatt.WGMMA),
    "f32_d64": (torch.float32, 256, 64, tatt.TF32X3),
    "f32_d128": (torch.float32, 256, 128, tatt.TF32X3),
    "bf16_d32": (torch.bfloat16, 256, 32, tatt.TF32X3),
    "bf16_d96": (torch.bfloat16, 128, 96, tatt.TF32X3),
    "bf16_ragged_seq": (torch.bfloat16, 100, 64, tatt.REFERENCE),
    "bf16_oversized_d": (torch.bfloat16, 128, 160, tatt.REFERENCE),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_is_chosen_by_shape_and_dtype(case):
    dtype, seq, d, route = ROUTES[case]
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, seq, 2, d).astype(np.float32)
                                * 0.5).to(dtype) for _ in range(3))
    assert tatt.kernel_route(q, k) == route
    # Declared shape and dtype decide, not the device: a meta tensor of
    # the same shape names the same route.
    meta = torch.empty(q.shape, dtype=dtype, device="meta")
    assert tatt.kernel_route(meta, meta) == route
    # On CPU tensors every route runs the plain version and counts no
    # launch on either kernel route, forward (K3) or backward (K4, K5).
    wrappers = (tatt.flash_attention, tatt.flash_backward_dq,
                tatt.flash_backward_dkv)
    counts = [c for fn in wrappers
              for c in (fn.launches, *fn.route_launches.values())]
    before = [c.value for c in counts]
    out = tatt.flash_attention(q, k, v, causal=True)
    if route == tatt.REFERENCE:
        want = tatt.reference_attention(q, k, v, causal=True)
    else:
        want, lse = tatt.flash_attention_reference(q, k, v, causal=True)
        do = torch.from_numpy(rng.randn(*q.shape).astype(np.float32)
                              ).to(dtype)
        args = (q, k, v, do, lse, tatt.attention_delta(want, do), True)
        torch.testing.assert_close(
            tatt.flash_backward_dq(*args),
            tatt.flash_backward_dq_reference(*args), rtol=0, atol=0)
        for got_g, want_g in zip(tatt.flash_backward_dkv(*args),
                                 tatt.flash_backward_dkv_reference(*args)):
            torch.testing.assert_close(got_g, want_g, rtol=0, atol=0)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert [c.value for c in counts] == before


def test_each_route_has_its_own_count():
    fwd = tatt.flash_attention.route_launches
    assert set(fwd) == {tatt.WGMMA, tatt.TF32X3}
    assert tatt.flash_attention_lse.route_launches is fwd
    dq = tatt.flash_backward_dq.route_launches
    dkv = tatt.flash_backward_dkv.route_launches
    assert set(dq) == set(dkv) == {tatt.WGMMA, tatt.TF32X3}
    counts = [tatt.flash_attention.launches, *fwd.values(),
              tatt.flash_backward_dq.launches, *dq.values(),
              tatt.flash_backward_dkv.launches, *dkv.values()]
    assert len({id(c) for c in counts}) == len(counts)


def test_no_route_is_named_for_the_cuda_cores():
    # Every kernel of the f32 route multiplies on the tensor cores, so no
    # route, and no launch count's key, is named "cuda-core".
    routes = {tatt.kernel_route(x, x) for dtype, seq, d, _ in ROUTES.values()
              for x in [torch.empty((1, seq, 2, d), dtype=dtype,
                                    device="meta")]}
    keys = {key for fn in (tatt.flash_attention, tatt.flash_backward_dq,
                           tatt.flash_backward_dkv)
            for key in fn.route_launches}
    assert routes == {tatt.WGMMA, tatt.TF32X3, tatt.REFERENCE}
    assert "cuda-core" not in routes | keys


# -- bindings -----------------------------------------------------------------

_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


def _c_argtype(param: str):
    """The ctypes type a C parameter declaration needs."""
    if "*" in param:
        return ctypes.c_void_p
    decl = re.sub(r"\bconst\b", "", param).split()
    return _C_TYPES[" ".join(decl[:-1])]


def c_entries(source: str) -> dict:
    """{name: [ctypes type per parameter]} of every ``extern "C"``
    function in a source."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / source).read_text())
    found = {}
    for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        found[m.group(1)] = [_c_argtype(p) for p in params]
    return found


class _Fn:
    argtypes = None
    restype = None


class StandInLibrary:
    """An object whose attributes take argtypes and restype, as a loaded
    ctypes library's functions do, recording which were asked for."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, _Fn())


def test_every_source_is_listed():
    assert sorted(_build.SOURCES.values()) == \
        sorted(p.name for p in _build.CSRC.glob("*.cu"))


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_bindings_match_the_c_signatures(name):
    want = c_entries(_build.SOURCES[name])
    assert want, f"no extern \"C\" entry found in {_build.SOURCES[name]}"
    lib = StandInLibrary()
    _build._bind(name, lib)
    assert set(lib.fns) == set(want)
    for entry, argtypes in want.items():
        assert lib.fns[entry].argtypes == argtypes, entry
        assert lib.fns[entry].restype is ctypes.c_int, entry


@pytest.mark.parametrize("wgmma,twin", [("attention_sm90", "attention"),
                                        ("attention_bwd_sm90",
                                         "attention_bwd")])
def test_each_wgmma_entry_takes_its_twins_arguments(wgmma, twin):
    # The wrappers call either route's entry with one argument list: K3's
    # forward, and K4's and K5's backward.
    fast = c_entries(_build.SOURCES[wgmma])
    plain = c_entries(_build.SOURCES[twin])
    assert set(fast) == {f"{name}_sm90" for name in plain}
    for name, argtypes in plain.items():
        assert fast[f"{name}_sm90"] == argtypes, name


def test_the_parser_reads_each_c_type_apart():
    # The parser reads pointer, int, long long and float parameters apart.
    assert [_c_argtype(p) for p in (
        "const void* q", "int batch", "long long qsb", "float scale",
        "void* stream")] == [ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_float,
                             ctypes.c_void_p]


def test_a_header_edit_changes_every_library_path(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    # An unchanged tree hashes the same.
    assert after == {n: _build.library_path(n) for n in _build.SOURCES}


def test_use_sources_points_the_build_at_a_copy(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    source = csrc / "attention.cu"
    source.write_text(source.read_text() + "\n// a variant\n")
    monkeypatch.setattr(_build, "CSRC", _build.CSRC)     # restored after
    monkeypatch.setattr(_build, "_libs", {"attention": object()})
    tree = _build.library_path("attention")
    variant = _build.library_path("attention", csrc)
    assert variant != tree
    _build.use_sources(csrc)
    assert _build.library_path("attention") == variant
    assert _build._libs == {}           # the tree's library is not handed out
