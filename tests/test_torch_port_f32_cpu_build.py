"""The f32 training kernels' CUDA sources, built for the CPU, against the
plain versions.

``csrc/block_f32.cu`` (rows 6f / 7f), ``csrc/mhsa_f32.cu`` (rows 4f / 5f),
``csrc/ada_f32.cu`` (rows 8f / 9f) and ``csrc/ca_f32.cu`` (rows 10f /
11f), with ``csrc/f32_ops.cuh`` and ``csrc/dec_tc32.cuh`` (the shim's
stand-ins for mma.sync, cp.async and cvt.rna check the 3xTF32 fragments'
indexing), are compiled by g++ over
``tests/cuda_cpu/shim_common.cuh`` (a thread block as OS threads; the
sources' launches ``k<<<...>>>(...)`` rewritten as calls of the shim's
launcher, ``extern __shared__`` as the block's buffer) and loaded in place
of the card's libraries; the wrappers of ``ops/fused_attention.py`` run on
CPU tensors as on the card (``_on_card`` answering yes), so the host entry
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


@pytest.fixture(scope="module")
def cpu_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("cuda_cpu")
    shutil.copy(SHIM, out / "common.cuh")
    sources = ("block_f32", "mhsa_f32", "ada_f32", "ca_f32")
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
         "-pthread", "-w", "-o", str(out / f"lib{name}.so"),
         str(out / f"{name}.cu")], stderr=subprocess.PIPE, text=True)
        for name in sources}
    for name, proc in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, f"{name}.cu:\n{err}"
    return {name.upper(): _CpuLibrary(getattr(_cuda, name.upper()),
                                      out / f"lib{name}.so")
            for name in sources}


def _as_card(libs, fn):
    def check(t, name, dtype, shape=None):
        assert t.dtype == dtype and t.is_contiguous(), name
        assert shape is None or tuple(t.shape) == tuple(shape), name

    patches = [mock.patch.object(fa, "_on_card", return_value=True),
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
