"""Serving and evaluating the 1723-vertex model on the CPU: the decoder
chain and whole block past their old vertex limits (rows K3 / 14 in bf16,
``csrc/coevo_chain.cu`` / ``csrc/coevo_block.cu`` over
``csrc/coevo_ops.cuh``; rows 3f / 14f in f32, ``csrc/coevo_f32.cu``).

- both plans (``coevo_plan``: one CTA a clip up to 450 vertices, else a
  cluster of 2, 4 or 8; ``coevo_f32_plan``: clusters of up to 16) at V =
  48 ... 2048 and one past, on 132 and 114 SMs and without a card: S, each
  rank's rows (whole tiles of 16 in rank order, every row once, at most
  256 / 128 a rank), the CTAs, the clusters and the waves; past the limit
  ``NotImplementedError`` naming it and ROADMAP.md B3;
- the gates (``coevo_kernel_fits``, ``_require_fits`` over a stub
  library) pass V = 1723 in both dtypes and still refuse other widths;
- the wrappers pass S and the plan's counts to the library at 1723 (and
  the one-CTA program's workspace at 431), the chain and the whole block,
  both dtypes (the card and the ``ctypes`` calls stood in for);
- a CPU model of the cluster split over the plain chain and whole block
  (``fc.attend`` patched; f32 also ``fc.mm``, the kernels' 3xTF32
  k-steps): the vertex self-attention as one online softmax through every
  rank's key chunks in rank order, the joint cross-attention a partial
  (o, max, sum) a rank merged in rank order; bf16 with the kernels' cast
  points (P rounded to bf16 in the tensor-core attentions, blocks of 16
  keys; the joints' attention f32 on the CUDA cores), against JAX's
  ``coevo_chain_reference`` / ``coevo_block_reference`` at V = 600 and
  1723: f32 within 1e-4, bf16 within ``BF16_BAND`` (measured, pinned);
- ``coevo_chain_plain`` / ``coevo_block_plain`` against JAX's interpreted
  ``fused_coevo_chain`` / ``fused_coevo_block`` at V = 600, f32 (1e-4);
- a narrow PMCE (embed 32, depth 1, batch 2) on the two-level coarsening
  (6890, 1723) in eval mode with ``fused=True`` (the chain, on the CPU its
  plain version) against JAX's PMCE through ``convert.py``'s weights, f32
  (1e-4 on the mesh, the evolved pose and the lifted pose).

The kernels themselves: ``tests/test_torch_port_f32_cpu_build.py``
(``slow``: the sources built for the CPU at 600 and 1723 vertices) and
the ``gpu`` cases of ``tests/test_torch_port_gpu.py``.
"""

from __future__ import annotations

import ctypes
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.models import pmce as jpmce
from pmce_tpu.ops import fused_attention as jfa
from pmce_tpu.ops import fused_coevo_chain as jfc
from pmce_tpu.smpl import mesh as jmesh
from pmce_tpu.smpl.artifacts import synthetic_artifacts as jart
from pmce_tpu_torch import convert
from pmce_tpu_torch.models.pmce import PMCE
from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.ops import fused_coevo_chain as fc
from test_torch_port_coevo_f32_redesign import _online, model_mm
from test_torch_port_f32_kernels import (_card_stubs, _chain_case,
                                         _coevo_block_case, _coevo_stubs, _j,
                                         _run, _t)
from torch_port_common import init_shapes, numpy_params

V_COARSE = 1723
F32_TOL = 1e-4
# The bf16 model against JAX's bf16 reference, relative to each output's
# largest magnitude: both round at their own cast points (JAX's bias adds
# in bf16, its P rounded whole where the model rounds each block's).
# Measured (joints / vertices): the chain 0.0032 / 0.0066 at V = 600, 0.0072
# / 0.0062 at 1723; the whole block 0.0042 / 0.0065 and 0.0081 / 0.0070.
# The band is 1.5 times the largest, rounded up.
BF16_BAND = {"chain": 0.011, "block": 0.013}

# ---------------------------------------------------------------------------
# The plans
# ---------------------------------------------------------------------------

# V -> S: bf16 one CTA a clip while three [V, 64] buffers fit (V <= 450),
# else the fewest of 2, 4, 8 whose rank (<= 256 rows) fits; f32 the fewest
# of 1, 2, 4, 8, 16 that leaves a rank <= 8 tiles of 16 rows.
SPLITS = {48: (1, 1), 431: (1, 4), 450: (1, 4), 451: (2, 4), 600: (4, 8),
          1024: (4, 8), 1025: (8, 16), 1723: (8, 16), 2048: (8, 16)}
LIMIT = 2048
# The clusters a card holds at once: one CTA an SM for bf16's one-CTA
# program; read on the NVIDIA H100 80GB HBM3 (132 SMs) for f32's clusters
# (fa._COEVO_F32_CLUSTERS) and bf16's (fc._COEVO_CLUSTERS), else SMs // S.
F32_CLUSTERS_132 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


def _clusters(dtype, sms, S):
    if dtype == "bf16":
        return sms if S == 1 else fc._COEVO_CLUSTERS.get((sms, S), sms // S)
    return F32_CLUSTERS_132[S] if sms == 132 else sms // S


def _plan(dtype, B, J, V, sms):
    return (fc.coevo_plan if dtype == "bf16" else fa.coevo_f32_plan)(
        B, J, V, sms)


@pytest.mark.parametrize("sms", [132, 114, None], ids=["132sm", "114sm",
                                                       "nocard"])
@pytest.mark.parametrize("V", list(SPLITS), ids=[f"V{v}" for v in SPLITS])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_plans_split_a_clip_into_ranks_of_whole_tiles(dtype, V, sms):
    S = SPLITS[V][dtype == "f32"]
    plan = _plan(dtype, 64, 19, V, sms)
    assert plan.splits == S
    assert plan.splits == (fc.coevo_splits(19, V) if dtype == "bf16"
                           else fa.coevo_f32_splits(V))
    rows = [r for r0, r1 in plan.rows for r in range(r0, r1)]
    assert rows == list(range(V))  # every row once, in rank order
    most = 128 if dtype == "f32" else (V if S == 1 else 256)
    assert all(r0 % 16 == 0 and 0 < r1 - r0 <= most for r0, r1 in plan.rows)
    sizes = [r1 - r0 for r0, r1 in plan.rows]
    assert max(sizes) - min(sizes) <= 16  # balanced to a tile
    assert plan.ctas == 64 * S
    if sms is None:
        assert plan.clusters is None and plan.waves is None
        return
    assert plan.clusters == _clusters(dtype, sms, S)
    assert plan.waves == -(-64 // plan.clusters)


def test_bf16_plan_keeps_one_cta_a_clip_at_the_shipped_431():
    """S = 1 at 431: the program the shipped path ran before, its shared
    memory the library's (three [431, 64] buffers and 16 rows)."""
    plan = fc.coevo_plan(256, 19, 431, 132)
    assert (plan.splits, plan.rows, plan.ctas, plan.smem) == (
        1, ((0, 431),), 256, 431 * 512 + 2048)
    assert (plan.clusters, plan.waves) == (132, 2)
    at = fc.coevo_plan(256, 19, V_COARSE, 132)
    assert at.splits == 8 and at.smem == fc.cluster_smem_bytes(19, 1723, 8)
    assert at.smem <= fc._SMEM_LIMIT
    assert max(r1 - r0 for r0, r1 in at.rows) == 224


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_plans_past_the_limit_raise_naming_it(dtype):
    _plan(dtype, 1, 19, LIMIT, None)
    with pytest.raises(NotImplementedError,
                       match=f"V <= {LIMIT}.*ROADMAP.md B3"):
        _plan(dtype, 1, 19, LIMIT + 1, None)


# ---------------------------------------------------------------------------
# The gates and the wrappers
# ---------------------------------------------------------------------------


def _bf16_stubs(seen, calls):
    """The bf16 libraries stood in for: the shared memory the library
    reports (the same rules as csrc/coevo_ops.cuh), the calls recorded."""
    def query(name, *args):
        if name.endswith("cluster_smem_bytes"):
            J, V, S = args
            return (fc.cluster_smem_bytes(J, V, S)
                    if fc._bf16_admits(J, V, S) else -1)
        if name.endswith("smem_bytes"):
            return fc.clip_smem_bytes(*args)
        return fc.clip_workspace_bytes(*args)

    def call(name, *args):
        seen.append(name)
        calls.append(args)

    libs = (_cuda.CHAIN, _cuda.COEVO_BLOCK)
    return _card_stubs(
        *(mock.patch.object(lib, "query", query) for lib in libs),
        *(mock.patch.object(lib, "call", call) for lib in libs),
        mock.patch.object(_cuda.COEVO_F32, "call",
                          side_effect=AssertionError("f32 ran")))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_gates_take_1723_and_refuse_other_widths(dtype):
    assert fc.coevo_kernel_fits(64, 256, 8, 2, V_COARSE)
    for widths in ((32, 128, 4, 1), (64, 128, 8, 2), (64, 256, 4, 2)):
        assert not fc.coevo_kernel_fits(*widths, V_COARSE)
    assert not fc.coevo_kernel_fits(64, 256, 8, 2, 47)
    lib, fn = ((_cuda.CHAIN, "pmce_chain_smem_bytes") if dtype == "bf16"
               else (_cuda.COEVO_F32, "pmce_coevo_f32_smem_bytes"))
    stubs = (_bf16_stubs([], []) if dtype == "bf16" else _coevo_stubs([]))
    _run(stubs, lambda: fc._require_fits("coevo_chain", 64, 256, 8, 2, 19,
                                         V_COARSE, lib, fn))
    with pytest.raises(NotImplementedError, match="not built for"):
        _run(stubs, lambda: fc._require_fits("coevo_chain", 64, 128, 8, 2,
                                             19, V_COARSE, lib, fn))
    with pytest.raises(NotImplementedError, match="V <= 2048.*ROADMAP.md B3"):
        _run(stubs, lambda: fc._require_fits("coevo_chain", 64, 256, 8, 2,
                                             19, 2064, lib, fn))


@pytest.mark.parametrize("V", [431, V_COARSE], ids=["V431", "V1723"])
@pytest.mark.parametrize("kind", ["chain", "block"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_wrappers_pass_the_plans_splits(dtype, kind, V):
    """One launch whose integers are B, J, V, (NB,) then the plan's S; bf16
    at 431 a workspace of B clips (one CTA a clip), in clusters none (a
    null pointer); the counter of the kernel's route raised once."""
    seen, calls = [], []
    if kind == "chain":
        inputs, blocks = _chain_case(17, batch=2, J=19, V=V)
        if dtype == "bf16":
            blocks = tuple((_t(b[0], torch.bfloat16), _t(b[1]),
                            _t(b[2], torch.bfloat16), *_t(b[3:]))
                           for b in blocks)
        else:
            blocks = _t(blocks)
        fn, args = fc.coevo_chain, (*_t(inputs), blocks)
    else:
        case = _coevo_block_case(18, batch=2, J=19, V=V)
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        fn, args = fc.coevo_block, (*_t(case[:2], dt), *_t(case[2:]))
    if dtype == "bf16":
        stubs = _bf16_stubs(seen, calls)
    else:
        def call(name, *a):
            seen.append(name)
            calls.append(a)
        stubs = _coevo_stubs([]) + [mock.patch.object(_cuda.COEVO_F32,
                                                      "call", call)]
    _cuda.reset_launch_counts()
    with torch.no_grad():
        out = _run(stubs, lambda: fn(*args, 8, 2))
    S = _plan(dtype, 2, 19, V, None).splits
    f32 = dtype == "f32"
    assert seen == [f"pmce_coevo_{kind}{'_f32' if f32 else ''}"]
    (cargs,) = calls
    n_ptr = (6 if kind == "chain" else 7) + (0 if f32 else 1)
    assert all(isinstance(a, ctypes.c_void_p) for a in cargs[:n_ptr])
    ints = cargs[n_ptr:-4]
    assert ints == ((2, 19, V, 3, S) if kind == "chain" else (2, 19, V, S))
    if not f32:
        ws = cargs[n_ptr - 1].value
        assert (ws is None) == (S > 1)
    counts = {k: v for k, v in _cuda.launch_counts().items() if v}
    assert counts == {f"coevo_{kind}{'_f32' if f32 else ''}": 1}
    assert all(o.shape[0] == 2 for o in out)


# ---------------------------------------------------------------------------
# The CPU model of the cluster split
# ---------------------------------------------------------------------------

CHUNK = 64


def _rbf(x):
    return x.to(torch.bfloat16).float()


def _online_bf16(q, k, v):
    """The tensor cores' attention (attn_kblock): blocks of 16 keys in
    order, the online softmax in f32, P rounded to bf16 for P.V."""
    m = l = o = None
    for c0 in range(0, k.shape[-2], 16):
        s = q @ k[..., c0:c0 + 16, :].transpose(-1, -2)
        mx = s.amax(-1, keepdim=True)
        mn = mx if m is None else torch.maximum(m, mx)
        p = torch.exp(s - mn)
        pv = _rbf(p) @ v[..., c0:c0 + 16, :]
        if m is None:
            l, o = p.sum(-1, keepdim=True), pv
        else:
            c = torch.exp(m - mn)
            l, o = l * c + p.sum(-1, keepdim=True), o * c + pv
        m = mn
    return o / l


def _rank_partial(q, k, v):
    """A rank's CUDA-core share of the joint CA: f32 softmax state over its
    keys (o unnormalised, max, sum)."""
    s = q @ k.transpose(-1, -2)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    return p @ v, m, p.sum(-1, keepdim=True)


def _merge(parts, exp=torch.exp):
    M = parts[0][1]
    for _, m, _ in parts[1:]:
        M = torch.maximum(M, m)
    O = L = 0.0
    for o, m, l in parts:
        f = exp(m - M)
        O, L = O + o * f, L + l * f
    return O / L


def cluster_attend(dtype, V):
    """``fc.attend`` as the kernels of ``dtype`` run it at V vertices, each
    rank's rows from the plan."""
    rows = _plan(dtype, 1, 17, V, None).rows

    def attend(q, k, v):
        q, k, v = q.float(), k.float(), v.float()
        Nq, Nk = q.shape[-2], k.shape[-2]
        if dtype == "f32":
            if Nk != V:  # keys over the joints: one chunk
                o, _, l = _online(q, k, v, [(0, Nk)])
                return o / l
            ranks = [[(c, min(c + CHUNK, r1)) for c in range(r0, r1, CHUNK)]
                     for r0, r1 in rows]
            if Nq == Nk:  # the vertex SA: every rank's chunks in order
                o, _, l = _online(q, k, v, [c for r in ranks for c in r])
                return o / l
            return _merge([_online(q, k, v, r) for r in ranks])
        if Nq == V:  # the vertex queries: the tensor cores
            return _online_bf16(q, k, v)
        if Nk != V:  # the joint SA: f32 on the CUDA cores
            return torch.softmax(q @ k.transpose(-1, -2), -1) @ v
        return _merge([_rank_partial(q, k[..., r0:r1, :], v[..., r0:r1, :])
                       for r0, r1 in rows])

    return attend


def _model(dtype, V, fn, *args):
    patches = [mock.patch.object(fc, "attend", cluster_attend(dtype, V))]
    if dtype == "f32":
        patches.append(mock.patch.object(fc, "mm", model_mm))
    with torch.no_grad():
        return _run(patches, lambda: fn(*args, 8, 2))


def _err(got, ref) -> float:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    return float(np.abs(got.float().numpy() - ref).max()
                 / np.abs(ref).max())


MODEL_CASES = [(600, 2, 17), (V_COARSE, 1, 19)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("V,batch,J", MODEL_CASES,
                         ids=["V600-B2-J17", "V1723-B1-J19"])
def test_cluster_model_of_the_chain_holds_against_jax(V, batch, J, dtype):
    inputs, blocks = _chain_case(J + V, batch=batch, J=J, V=V)
    if dtype == "bf16":
        bf = jnp.bfloat16
        jblocks = tuple((jnp.asarray(b[0], bf), jnp.asarray(b[1]),
                         jnp.asarray(b[2], bf), *_j(b[3:])) for b in blocks)
        tblocks = tuple((_t(b[0], torch.bfloat16), _t(b[1]),
                         _t(b[2], torch.bfloat16), *_t(b[3:]))
                        for b in blocks)
    else:
        jblocks, tblocks = _j(blocks), _t(blocks)
    got = _model(dtype, V, fc.coevo_chain_plain, *_t(inputs), tblocks)
    ref = jfc.coevo_chain_reference(*_j(inputs), jblocks, 8, 2)
    errs = [_err(a, r) for a, r in zip(got, ref)]
    print(f"{dtype} cluster model of the chain, V={V}: {errs}")
    assert all(a.shape == tuple(r.shape) for a, r in zip(got, ref))
    assert max(errs) <= (F32_TOL if dtype == "f32" else BF16_BAND["chain"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("V,batch,J", MODEL_CASES,
                         ids=["V600-B2-J17", "V1723-B1-J19"])
def test_cluster_model_of_the_whole_block_holds_against_jax(V, batch, J,
                                                            dtype):
    case = _coevo_block_case(J + V + 1, batch=batch, J=J, V=V)
    if dtype == "bf16":
        feats = (_t(case[:2], torch.bfloat16),
                 tuple(jnp.asarray(a, jnp.bfloat16) for a in case[:2]))
    else:
        feats = (_t(case[:2]), _j(case[:2]))
    got = _model(dtype, V, fc.coevo_block_plain, *feats[0], *_t(case[2:]))
    ref = jfa.coevo_block_reference(*feats[1], *_j(case[2:]), 8, 2)
    errs = [_err(a, r) for a, r in zip(got, ref)]
    print(f"{dtype} cluster model of the whole block, V={V}: {errs}")
    assert all(a.shape == tuple(r.shape) for a, r in zip(got, ref))
    assert max(errs) <= (F32_TOL if dtype == "f32" else BF16_BAND["block"])


@pytest.mark.parametrize("kind", ["chain", "block"])
def test_cluster_model_differs_from_the_plain_version(kind):
    """The model reaches the chain's and the whole block's attention (its
    bf16 P rounding moves the outputs off the plain version's)."""
    V = 600
    if kind == "chain":
        inputs, blocks = _chain_case(5, batch=1, J=17, V=V)
        blocks = tuple((_t(b[0], torch.bfloat16), _t(b[1]),
                        _t(b[2], torch.bfloat16), *_t(b[3:]))
                       for b in blocks)
        args, fn = (*_t(inputs), blocks), fc.coevo_chain_plain
    else:
        case = _coevo_block_case(6, batch=1, J=17, V=V)
        args = (*_t(case[:2], torch.bfloat16), *_t(case[2:]))
        fn = fc.coevo_block_plain
    got = _model("bf16", V, fn, *args)
    with torch.no_grad():
        want = fn(*args, 8, 2)
    assert any(not torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# The plain versions against JAX's interpreted kernels at 600 vertices
# ---------------------------------------------------------------------------


def test_plain_chain_matches_jax_kernel_at_600():
    inputs, blocks = _chain_case(60, batch=2, J=17, V=600)
    want = jfc.fused_coevo_chain(*_j(inputs), _j(blocks), 8, 2)
    with torch.no_grad():
        got = fc.coevo_chain_plain(*_t(inputs), _t(blocks), 8, 2)
    errs = [_err(a, r) for a, r in zip(got, want)]
    print(f"plain chain vs JAX's interpreted kernel at 600: {errs}")
    assert max(errs) <= F32_TOL


def test_plain_whole_block_matches_jax_kernel_at_600():
    case = _coevo_block_case(61, batch=2, J=19, V=600)
    want = jfa.fused_coevo_block(*_j(case), 8, 2)
    with torch.no_grad():
        got = fc.coevo_block_plain(*_t(case), 8, 2)
    errs = [_err(a, r) for a, r in zip(got, want)]
    print(f"plain whole block vs JAX's interpreted kernel at 600: {errs}")
    assert max(errs) <= F32_TOL


# ---------------------------------------------------------------------------
# A narrow PMCE on the two-level coarsening, eval mode, against JAX
# ---------------------------------------------------------------------------

NARROW = dict(embed_dim=32, depth=1, num_vertx=V_COARSE, num_verts_full=6890,
              joint_dim=64, vertx_dim=64, gru_hidden=32, seqlen=16)


def test_narrow_pmce_at_1723_evaluates_as_jax():
    """The port's eval forward, ``fused=True`` (the chain once; on the CPU
    its plain version), against JAX's PMCE (``fused_attn=False``: its
    reference path, which the interpreted chain matches at 600 above) on
    the same inputs, weights through ``convert.py``: f32 within 1e-4 of
    each output's largest magnitude."""
    coarse = jmesh.synthetic_coarsening(sizes=(6890, V_COARSE))
    vj = tuple(int(i) for i in
               jpmce.default_assets(jart(seed=0), coarse).vj_relation)
    rng = np.random.default_rng(27)
    pose2d = rng.standard_normal((2, 16, 17, 2), dtype=np.float32)
    feat = rng.standard_normal((2, 16, 2048), dtype=np.float32)
    jm = jpmce.PMCE(num_joint=17, vj_relation=vj, fused_attn=False,
                    **NARROW)
    params = numpy_params(init_shapes(jm, pose2d[:1], feat[:1]), 27)
    want = jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b))(
        jax.tree_util.tree_map(jnp.asarray, params), pose2d, feat)
    model = PMCE(num_joint=17, vj_relation=vj, dtype=None, fused=True,
                 **NARROW)
    model.load_state_dict(convert.state_dict_from_jax(params, vj),
                          strict=True)
    with mock.patch.object(fc, "coevo_chain", wraps=fc.coevo_chain) as chain, \
            torch.no_grad():
        got = model.eval()(torch.from_numpy(pose2d), torch.from_numpy(feat))
    assert chain.call_count == 1
    assert chain.call_args.args[1].shape == (2, V_COARSE, 3)
    for name, a, r in zip(("mesh", "evo_pose", "pose3d"), got, want):
        err = _err(a, r)
        print(f"narrow PMCE at 1723, {name}: {err:.3g}")
        assert a.shape == tuple(r.shape) and err <= F32_TOL, (name, err)
