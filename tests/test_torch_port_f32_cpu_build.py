"""The f32 kernels' CUDA sources, built for the CPU, against the plain
versions.

``csrc/block_f32.cu`` (rows 6f / 7f), ``csrc/mhsa_f32.cu`` (rows 4f / 5f),
``csrc/ada_f32.cu`` (rows 8f / 9f), ``csrc/ca_f32.cu`` (rows 10f / 11f)
and ``csrc/coevo_f32.cu`` (rows 3f / 14f), with ``csrc/f32_ops.cuh`` and
``csrc/dec_tc32.cuh`` (the shim's stand-ins for mma.sync, cp.async and
cvt.rna check the 3xTF32 fragments' indexing), are compiled by g++ over
``tests/cuda_cpu/shim_common.cuh`` (a thread block as OS threads, a
cluster's blocks at once; the sources' launches ``k<<<...>>>(...)``
rewritten as calls of the shim's launcher, ``extern __shared__`` as the
block's buffer) and loaded in place of the card's libraries; the wrappers
of ``ops/fused_attention.py`` and ``ops/fused_coevo_chain.py`` run on CPU
tensors as on the card (``_on_card`` answering yes), so the host entry
points, the pointer tables and the kernels' arithmetic are all exercised.
Forward and every gradient (mask gradients included) within 1e-5 of the
plain version's autograd, relative to each one's largest magnitude (f32 on
both sides, sums in another order; measured ≤ 1.1e-6; the CA block's key
bias and key AdaLN beta, zero analytically, relative to the largest
gradient). It checks a source before its first call on the card; ``slow``
(~2 min: the builds, 256 or 512 threads a block).
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.ops import fused_coevo_chain as fc

pytestmark = pytest.mark.slow

SHIM = Path(__file__).parent / "cuda_cpu" / "shim_common.cuh"
TOL = 1e-5


class _CpuLibrary(_cuda.CudaLibrary):
    def __init__(self, lib, so: Path):
        super().__init__(lib.source, lib.error_fn, lib.signatures)
        self.so = so

    @property
    def path(self) -> Path:
        return self.so


def _build_cpu_libs(out: Path, sources, defines=()):
    shutil.copy(SHIM, out / "common.cuh")
    for name in (*(f"{n}.cu" for n in sources), "f32_ops.cuh",
                 "dec_tc32.cuh"):
        text = (_cuda.CSRC / name).read_text()
        text = text.replace(
            "extern __shared__ __align__(16) unsigned char smem[];",
            "unsigned char* smem = shim::blk->smem;")
        text = re.sub(r"(\w+)\s*<<<(.*?)>>>\(", r"shim::launch(\1, \2, ",
                      text, flags=re.S)
        (out / name).write_text(text.replace("__restrict__", ""))
    procs = {name: subprocess.Popen(
        ["g++", "-x", "c++", "-O2", "-std=c++20", "-fPIC", "-shared",
         "-pthread", "-w", *defines, "-o", str(out / f"lib{name}.so"),
         str(out / f"{name}.cu")], stderr=subprocess.PIPE, text=True)
        for name in sources}
    for name, proc in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, f"{name}.cu:\n{err}"
    return {name.upper(): _CpuLibrary(getattr(_cuda, name.upper()),
                                      out / f"lib{name}.so")
            for name in sources}


@pytest.fixture(scope="module")
def cpu_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return _build_cpu_libs(tmp_path_factory.mktemp("cuda_cpu"), (
        "block_f32", "mhsa_f32", "ada_f32", "ca_f32", "coevo_f32"))


@pytest.fixture(scope="module")
def window_libs(tmp_path_factory):
    """The decoder sources with a ring window of 3 items
    (``PMCE_DEC_QTAB``): every program's list of a tile's staged items
    refilled, at 600 tokens a streamed side's 10 chunks and the tails'
    weights several times a tile."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return _build_cpu_libs(tmp_path_factory.mktemp("cuda_cpu_window"),
                           ("ada_f32", "ca_f32"), ("-DPMCE_DEC_QTAB=3",))


def _as_card(libs, fn):
    def check(t, name, dtype, shape=None):
        assert t.dtype == dtype and t.is_contiguous(), name
        assert shape is None or tuple(t.shape) == tuple(shape), name

    patches = [mock.patch.object(fa, "_on_card", return_value=True),
               mock.patch.object(fc, "_on_card", return_value=True),
               mock.patch.object(fc._Table, "device", lambda self:
                                 torch.tensor(self.ptrs, dtype=torch.int64)),
               mock.patch.object(_cuda, "check_cuda", check),
               mock.patch.object(_cuda, "stream_ptr",
                                 return_value=_cuda.P(None)),
               *(mock.patch.object(_cuda, k, v) for k, v in libs.items())]
    for p in patches:
        p.start()
    try:
        _cuda.reset_launch_counts()
        return fn(), {k: v for k, v in _cuda.launch_counts().items() if v}
    finally:
        for p in reversed(patches):
            p.stop()


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _t(rng, *shape, scale=1.0, offset=0.0, grad=True):
    a = (rng.normal(size=shape) * scale + offset).astype(np.float32)
    return torch.from_numpy(a).requires_grad_(grad)


def test_block_f32_sources_match_plain_on_the_cpu(cpu_libs):
    """Rows 6f / 7f: 4 clips of 17 (two tiles: 3 clips, then one and
    padding rows), C 256, heads of 32, hid 128, the post-norm, masks that
    require grad (each branch dropped for one clip)."""
    rng = np.random.default_rng(0)
    C, hid, clips, N = 256, 128, 4, 17
    params = (_t(rng, C, scale=0.1, offset=1.0), _t(rng, C, scale=0.1),
              _t(rng, C, 3 * C, scale=C ** -0.5), _t(rng, 3 * C, scale=0.05),
              _t(rng, C, C, scale=C ** -0.5), _t(rng, C, scale=0.05),
              _t(rng, C, scale=0.1, offset=1.0), _t(rng, C, scale=0.1),
              _t(rng, C, hid, scale=C ** -0.5), _t(rng, hid, scale=0.05),
              _t(rng, hid, C, scale=hid ** -0.5), _t(rng, C, scale=0.05),
              _t(rng, C, scale=0.1, offset=1.0), _t(rng, C, scale=0.1))
    x = _t(rng, clips, N, C)
    masks = tuple(torch.tensor([[[0.0]], [[1.25]], [[1.25]], [[1.25]]])
                  [perm].requires_grad_(True) for perm in ([0, 1, 2, 3],
                                                           [1, 0, 2, 3]))
    g = _t(rng, clips, N, C, grad=False)
    leaves = [x, *params, *masks]

    def step(block):
        y = block(x, params, 8, branch_masks=masks)
        return (y, *torch.autograd.grad(y, leaves, g))

    got, counts = _as_card(cpu_libs, lambda: step(fa.transformer_block))
    want = step(fa.transformer_block_plain)
    assert counts == {"block_fwd_f32": 1, "block_bwd_f32": 1}
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and _rel(a, b) <= TOL, (i, _rel(a, b))


@pytest.mark.parametrize("N,C,heads", [(17, 64, 8), (19, 128, 4)])
def test_mhsa_f32_sources_match_plain_on_the_cpu(cpu_libs, N, C, heads):
    """Rows 4f / 5f: 3 clips, forward and the four parameter gradients."""
    rng = np.random.default_rng(N)
    leaves = [_t(rng, 3, N, C), _t(rng, C, 3 * C, scale=C ** -0.5),
              _t(rng, 3 * C, scale=0.05), _t(rng, C, C, scale=C ** -0.5),
              _t(rng, C, scale=0.05)]
    g = _t(rng, 3, N, C, grad=False)

    def step(mhsa):
        y = mhsa(*leaves, heads)
        return (y, *torch.autograd.grad(y, leaves, g))

    got, counts = _as_card(cpu_libs, lambda: step(fa.fused_mhsa))
    want = step(fa.mhsa_plain)
    assert counts == {"mhsa_fwd_f32": 1, "mhsa_bwd_f32": 1}
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and _rel(a, b) <= TOL, (i, _rel(a, b))


@pytest.mark.parametrize("clips,N,C,heads,resident", [(3, 17, 64, 8, 1),
                                                       (2, 40, 128, 16, 2),
                                                       (2, 19, 256, 8, 3)])
def test_mhsa_f32_sources_match_plain_with_few_ctas(cpu_libs, clips, N, C,
                                                    heads, resident):
    """Rows 4f / 5f (items of a clip's 16 rows on a persistent grid) with ``mhsa_f32_plan`` cut to 1-3 CTAs, so that a CTA
    runs items of several clips and column blocks (C 128 and 256: two and
    four); the weight launch on its host plan's two row ranges. Forward and
    every gradient within 1e-5 of the plain version, a rerun bit for bit."""
    rng = np.random.default_rng(N + C)
    leaves = [_t(rng, clips, N, C), _t(rng, C, 3 * C, scale=C ** -0.5),
              _t(rng, 3 * C, scale=0.05), _t(rng, C, C, scale=C ** -0.5),
              _t(rng, C, scale=0.05)]
    g = _t(rng, clips, N, C, grad=False)

    def step(mhsa):
        y = mhsa(*leaves, heads)
        return (y, *torch.autograd.grad(y, leaves, g))

    assert fa.mhsa_f32_plan(clips, N, resident).waves > 1
    with mock.patch.object(fa, "_mhsa_f32_resident", return_value=resident):
        got, counts = _as_card(cpu_libs, lambda: step(fa.fused_mhsa))
        again, _ = _as_card(cpu_libs, lambda: step(fa.fused_mhsa))
    want = step(fa.mhsa_plain)
    assert counts == {"mhsa_fwd_f32": 1, "mhsa_bwd_f32": 1}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and _rel(a, b) <= TOL, (i, _rel(a, b))


def _dec_masks(clips):
    return tuple(torch.tensor([[[0.0]]] + [[[1.25]]] * (clips - 1))[perm]
                 .requires_grad_(True) for perm in (
                     list(range(clips)), [1, 0, *range(2, clips)]))


def _check(got, want, counts, expect, zero=()):
    assert counts == expect
    largest = max(float(b.abs().max()) for b in want[1:])
    for i, (a, b) in enumerate(zip(got, want)):
        err = (float((a - b).abs().max()) / largest if i - 1 in zero
               else _rel(a, b))
        assert a.shape == b.shape and err <= TOL, (i, err)


@pytest.mark.parametrize("clips,N,heads,hid", [(2, 72, 2, 128),
                                               (3, 70, 8, 64),
                                               (2, 72, 4, 64)])
def test_ada_f32_source_matches_plain_on_the_cpu(cpu_libs, clips, N, heads,
                                                 hid):
    """Rows 8f / 9f: one 128-row tile a clip (its last warps partly or not
    at all filled), the key side in two 64-row chunks, masks that require
    grad (each branch dropped for one clip)."""
    rng = np.random.default_rng(N)
    C = 64
    x = _t(rng, clips, N, C)
    gb = [_t(rng, clips, C, scale=0.1, offset=1.0 - i % 2) for i in range(4)]
    params = [_t(rng, C, 3 * C, scale=C ** -0.5), _t(rng, 3 * C, scale=0.05),
              _t(rng, C, C, scale=C ** -0.5), _t(rng, C, scale=0.05),
              _t(rng, C, hid, scale=C ** -0.5), _t(rng, hid, scale=0.05),
              _t(rng, hid, C, scale=hid ** -0.5), _t(rng, C, scale=0.05)]
    masks = _dec_masks(clips)
    g = _t(rng, clips, N, C, grad=False)
    leaves = [x, *gb, *params, *masks]

    def step(block):
        y = block(x, *gb, params, heads, 1e-6, masks)
        return (y, *torch.autograd.grad(y, leaves, g))

    got, counts = _as_card(cpu_libs, lambda: step(fa.ada_block))
    _check(got, step(fa.ada_block_plain), counts,
           {"ada_fwd_f32": 1, "ada_bwd_f32": 1})


@pytest.mark.parametrize("Nq,Nk,heads,hid", [(17, 72, 8, 128),
                                             (72, 17, 2, 64),
                                             (20, 72, 4, 64)])
def test_ca_f32_source_matches_plain_on_the_cpu(cpu_libs, Nq, Nk, heads,
                                                hid):
    """Rows 10f / 11f in both orientations (the long side in two 64-row
    chunks), masks that require grad."""
    rng = np.random.default_rng(Nq + 2 * Nk)
    C, clips = 64, 2
    xs = [_t(rng, clips, n, C) for n in (Nq, Nk, Nk)]
    conds = [_t(rng, clips, C, scale=0.1, offset=1.0 - i % 2)
             for i in range(8)]
    params = [t for _ in range(4) for t in (
        _t(rng, C, C, scale=C ** -0.5), _t(rng, C, scale=0.05))]
    params += [_t(rng, C, hid, scale=C ** -0.5), _t(rng, hid, scale=0.05),
               _t(rng, hid, C, scale=hid ** -0.5), _t(rng, C, scale=0.05)]
    masks = _dec_masks(clips)
    g = _t(rng, clips, Nq, C, grad=False)
    leaves = [*xs, *conds, *params, *masks]

    def step(block):
        y = block(*xs, conds[0::2], conds[1::2], params, heads, 1e-6, masks)
        return (y, *torch.autograd.grad(y, leaves, g))

    got, counts = _as_card(cpu_libs, lambda: step(fa.ca_block))
    # Leaves 6 and 14: the keys' AdaLN beta and bias.
    _check(got, step(fa.ca_block_plain), counts,
           {"ca_fwd_f32": 1, "ca_bwd_f32": 1}, zero=(6, 14))


@pytest.mark.parametrize("Nq,Nk,heads", [(17, 431, 8), (431, 17, 2)])
def test_ca_f32_split_short_side_matches_plain_on_the_cpu(cpu_libs, Nq, Nk,
                                                          heads):
    """Row 11f at a short side of 17 over a long side of 431 (Stage 2's
    joints and vertices) both ways, under the split plan: 4 CTAs of the
    short side's program over the long side's 7 chunks (the card's
    co-resident count stood in for), their partials merged in order; one
    clip, masks that require grad."""
    rng = np.random.default_rng(Nq + 2 * Nk)
    C, clips, hid = 64, 1, 64
    xs = [_t(rng, clips, n, C) for n in (Nq, Nk, Nk)]
    conds = [_t(rng, clips, C, scale=0.1, offset=1.0 - i % 2)
             for i in range(8)]
    params = [t for _ in range(4) for t in (
        _t(rng, C, C, scale=C ** -0.5), _t(rng, C, scale=0.05))]
    params += [_t(rng, C, hid, scale=C ** -0.5), _t(rng, hid, scale=0.05),
               _t(rng, hid, C, scale=hid ** -0.5), _t(rng, C, scale=0.05)]
    masks = tuple(torch.tensor([[[1.25]]]).requires_grad_(True)
                  for _ in range(2))
    g = _t(rng, clips, Nq, C, grad=False)
    leaves = [*xs, *conds, *params, *masks]

    def step(block):
        y = block(*xs, conds[0::2], conds[1::2], params, heads, 1e-6, masks)
        return (y, *torch.autograd.grad(y, leaves, g))

    plan = fa.f32_dec_plan("ca", clips, Nq, Nk, 4)
    assert max(plan.splits_q, plan.splits_k) == 4
    with mock.patch.object(fa, "_dec_f32_resident", return_value=4):
        got, counts = _as_card(cpu_libs, lambda: step(fa.ca_block))
    _check(got, step(fa.ca_block_plain), counts,
           {"ca_fwd_f32": 1, "ca_bwd_f32": 1}, zero=(6, 14))


@pytest.mark.parametrize("window", ["window-16", "window-3"])
@pytest.mark.parametrize("kind,Nq,Nk,heads,resident", [
    ("ada", 600, 600, 2, None), ("ca", 17, 600, 8, 4),
    ("ca", 600, 17, 2, 4)],
    ids=["ada-600", "ca-17-over-600-split4", "ca-600-over-17-split4"])
def test_dec_f32_sources_at_600_tokens_match_plain(request, window, kind,
                                                   Nq, Nk, heads, resident):
    """Rows 8f-11f past 512 tokens (the gates' old limit): one clip at a
    long side of 600 (5 tiles of 128 rows, 10 chunks of 64 streamed), the
    CA block's short side split 4 ways over the long side's chunks (the
    card's co-resident count stood in for), masks that require grad;
    forward and every gradient within 1e-5 of the plain version's
    autograd. Built as shipped (a window of 16 staged items: the
    attention's 10 chunks in one) and with a window of 3 (every list
    refilled)."""
    libs = request.getfixturevalue("cpu_libs" if window == "window-16"
                                   else "window_libs")
    rng = np.random.default_rng(Nq + 3 * Nk + heads)
    C, clips, hid = 64, 1, 64
    masks = tuple(torch.tensor([[[1.25]]]).requires_grad_(True)
                  for _ in range(2))
    if kind == "ada":
        xs = [_t(rng, clips, Nq, C)]
        conds = [_t(rng, clips, C, scale=0.1, offset=1.0 - i % 2)
                 for i in range(4)]
        params = [_t(rng, C, 3 * C, scale=C ** -0.5),
                  _t(rng, 3 * C, scale=0.05)]
    else:
        xs = [_t(rng, clips, n, C) for n in (Nq, Nk, Nk)]
        conds = [_t(rng, clips, C, scale=0.1, offset=1.0 - i % 2)
                 for i in range(8)]
        params = [t for _ in range(3) for t in (
            _t(rng, C, C, scale=C ** -0.5), _t(rng, C, scale=0.05))]
    params += [_t(rng, C, C, scale=C ** -0.5), _t(rng, C, scale=0.05),
               _t(rng, C, hid, scale=C ** -0.5), _t(rng, hid, scale=0.05),
               _t(rng, hid, C, scale=hid ** -0.5), _t(rng, C, scale=0.05)]
    g = _t(rng, clips, Nq, C, grad=False)
    leaves = [*xs, *conds, *params, *masks]

    def step(block):
        if kind == "ada":
            y = block(*xs, *conds, params, heads, 1e-6, masks)
        else:
            y = block(*xs, conds[0::2], conds[1::2], params, heads, 1e-6,
                      masks)
        return (y, *torch.autograd.grad(y, leaves, g))

    fn, plain = ((fa.ada_block, fa.ada_block_plain) if kind == "ada"
                 else (fa.ca_block, fa.ca_block_plain))
    with mock.patch.object(fa, "_dec_f32_resident", return_value=resident):
        got, counts = _as_card(libs, lambda: step(fn))
    _check(got, step(plain), counts,
           {f"{kind}_fwd_f32": 1, f"{kind}_bwd_f32": 1},
           zero=(6, 14) if kind == "ca" else ())


@pytest.mark.parametrize("kind,clips,Nq,Nk,heads,resident", [
    ("ada", 3, 200, 200, 4, 2), ("ada", 2, 72, 72, 2, 1),
    ("ca", 2, 17, 200, 8, 6), ("ca", 3, 200, 17, 4, 3)],
    ids=["ada-16wide-2ctas", "ada-1cta", "ca-joints-split3",
         "ca-vertices-16wide-3ctas"])
def test_dec_f32_forwards_match_plain_with_few_ctas(cpu_libs, kind, clips,
                                                    Nq, Nk, heads,
                                                    resident):
    """Rows 8f / 10f alone (no gradient owed, masks given) on
    ``f32_dec_fwd_plan``'s grids cut to a few CTAs (the card's co-resident
    count stood in for): several tiles a CTA in every program; joints over
    vertices split 3 ways over the long side's 4 chunks, the partials
    merged by the tail; heads of 16 and 32 and 8."""
    rng = np.random.default_rng(Nq + 5 * Nk + heads)
    C, hid = 64, 128
    masks = _dec_masks(clips)
    if kind == "ada":
        x = _t(rng, clips, Nq, C, grad=False)
        gb = [_t(rng, clips, C, scale=0.1, offset=1.0 - i % 2, grad=False)
              for i in range(4)]
        params = [_t(rng, C, 3 * C, scale=C ** -0.5, grad=False),
                  _t(rng, 3 * C, scale=0.05, grad=False)]
    else:
        xs = [_t(rng, clips, n, C, grad=False) for n in (Nq, Nk, Nk)]
        conds = [_t(rng, clips, C, scale=0.1, offset=1.0 - i % 2,
                    grad=False) for i in range(8)]
        params = [t for _ in range(3) for t in (
            _t(rng, C, C, scale=C ** -0.5, grad=False),
            _t(rng, C, scale=0.05, grad=False))]
    params += [_t(rng, C, C, scale=C ** -0.5, grad=False),
               _t(rng, C, scale=0.05, grad=False),
               _t(rng, C, hid, scale=C ** -0.5, grad=False),
               _t(rng, hid, scale=0.05, grad=False),
               _t(rng, hid, C, scale=hid ** -0.5, grad=False),
               _t(rng, C, scale=0.05, grad=False)]
    masks = tuple(m.detach() for m in masks)

    def run(fn):
        with torch.no_grad():
            if kind == "ada":
                return fn(x, *gb, params, heads, 1e-6, masks)
            return fn(*xs, conds[0::2], conds[1::2], params, heads, 1e-6,
                      masks)

    plan = fa.f32_dec_fwd_plan(kind, clips, Nq, Nk, resident)
    assert max(p.waves for p in plan.programs) >= 2 or plan.splits_q > 1
    with mock.patch.object(fa, "_dec_f32_resident", return_value=resident):
        got, counts = _as_card(cpu_libs, lambda: run(
            fa.ada_block if kind == "ada" else fa.ca_block))
    assert counts == {f"{kind}_fwd_f32": 1}
    want = run(fa.ada_block_plain if kind == "ada" else fa.ca_block_plain)
    assert got.shape == want.shape and _rel(got, want) <= TOL, _rel(got,
                                                                    want)


def _coevo_params(rng, J, V, C=64, hid=256):
    def w(i, o):
        return _t(rng, i, o, scale=i ** -0.5, grad=False)

    def v(*shape, scale=0.05):
        return _t(rng, *shape, scale=scale, grad=False)

    def ca():
        return (w(C, C), v(C), w(C, C), v(C), w(C, C), v(C), w(C, C), v(C),
                w(C, hid), v(hid), w(hid, C), v(C))

    def sa():
        return (w(C, 3 * C), v(3 * C), w(C, C), v(C), w(C, hid), v(hid),
                w(hid, C), v(C))

    return (v(J, C, scale=1.0), v(V, C, scale=1.0), v(J, C, scale=1.0),
            v(V, C, scale=1.0), v(V, C, scale=1.0), v(J, C, scale=1.0),
            w(C, C), v(C), w(C, C), v(C), ca(), ca(), sa(), sa())


@pytest.mark.parametrize("kind,clips,J,V,S", [
    ("chain", 2, 17, 72, 2), ("chain", 1, 19, 200, 2),
    ("block", 2, 19, 72, 3), ("block", 1, 17, 100, 1)],
    ids=["chain-2x2", "chain-2chunks-a-rank", "block-3x2", "block-1"])
def test_coevo_f32_source_matches_plain_with_few_clusters(cpu_libs, kind,
                                                          clips, J, V, S):
    """Rows 3f / 14f: the chain (3 blocks, the coordinate heads) and the
    whole block on clusters of S CTAs (the plan's S stood in for: the
    shipped V = 431 takes 4), a few clusters: ranks of one and of two
    64-row chunks (V = 200 in two ranks of 96 and 104 rows), a rank's last
    warps without rows, joints of one and two tiles."""
    rng = np.random.default_rng(V + 3 * J + S)
    C = 64
    if kind == "chain":
        blocks = tuple(
            (_t(rng, 3, C, scale=3 ** -0.5, grad=False),
             _t(rng, C, scale=0.05, grad=False),
             _t(rng, 3, C, scale=3 ** -0.5, grad=False),
             _t(rng, C, scale=0.05, grad=False), _coevo_params(rng, J, V),
             _t(rng, C, 3, scale=C ** -0.5, grad=False),
             _t(rng, 3, scale=0.05, grad=False),
             _t(rng, C, 3, scale=C ** -0.5, grad=False),
             _t(rng, 3, scale=0.05, grad=False)) for _ in range(3))
        args = (_t(rng, clips, J, 3, scale=0.3, grad=False),
                _t(rng, clips, V, 3, scale=0.3, grad=False),
                _t(rng, clips, 3, 12, C, scale=0.1, offset=1.0, grad=False),
                _t(rng, clips, 3, 12, C, scale=0.1, grad=False), blocks)
        fn, plain = fc.coevo_chain, fc.coevo_chain_plain
    else:
        args = (_t(rng, clips, J, C, grad=False),
                _t(rng, clips, V, C, grad=False),
                _t(rng, clips, 12, C, scale=0.1, offset=1.0, grad=False),
                _t(rng, clips, 12, C, scale=0.1, grad=False),
                _coevo_params(rng, J, V))
        fn, plain = fc.coevo_block, fc.coevo_block_plain
    plan = fa.coevo_f32_plan(clips, J, V, None)
    tiles = -(-V // 16)
    rows = tuple((16 * (tiles * r // S), min(V, 16 * (tiles * (r + 1) // S)))
                 for r in range(S))
    with torch.no_grad(), mock.patch.object(
            fc, "coevo_f32_plan", return_value=plan._replace(
                splits=S, rows=rows, ctas=clips * S)):
        got, counts = _as_card(cpu_libs, lambda: fn(*args, 8, 2))
        want = plain(*args, 8, 2)
    assert counts == {f"coevo_{kind}_f32": 1}
    for a, b in zip(got, want):
        print(f"{kind} S={S}: {_rel(a, b):.3g}")
        assert a.shape == b.shape and _rel(a, b) <= TOL, _rel(a, b)
