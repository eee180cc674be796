"""The decoder's co-evolution blocks, in PyTorch and CUDA: one block, or
the whole chain.

Port of ``pmce_tpu/ops/fused_coevo_chain.py`` (``fused_coevo_chain``: all
CoevoBlocks plus their f32 coordinate heads) and of
``fused_coevo_block`` in ``pmce_tpu/ops/fused_attention.py`` (one
CoevoBlock's token program, features in and out, the heads outside). Per
block, with the reference quirks kept: 3 → C projections of the ORIGINAL
joints (every block re-reads them) and of the current vertices; pos, Q and
K embeds; the v→j and j→v projections; joint CA+FFN and vertex CA+FFN, both
on the PRE-update streams; AdaLN'd SA+FFN per stream; f32 C → 3 heads plus
residuals.

:func:`coevo_block_plain` has the math of ``coevo_block_reference``, and
:func:`coevo_chain_plain` that of ``coevo_chain_reference`` (its embeds, one
block each, its heads), with the kernels' cast points: f32 sums of bf16
products, one rounding each, f32 streams between the residual adds (the
chain's heads read the f32 streams); in f32 compute every tensor is f32
and nothing rounds. :func:`coevo_block` and :func:`coevo_chain` run them
for CPU tensors and, for CUDA tensors, the kernels of
``csrc/coevo_block.cu`` and ``csrc/coevo_chain.cu`` (both over
``csrc/coevo_ops.cuh``: one CTA a clip while its vertex stream fits in
shared memory, V <= 450, else a cluster of 2, 4 or 8 CTAs a clip,
:func:`coevo_plan`) in bf16 compute and those of ``csrc/coevo_f32.cu``
in f32 compute (a cluster of up to 16 CTAs a clip,
:func:`coevo_f32_plan`); on the card a shape those kernels are not built
for (:func:`coevo_kernel_fits`, a vertex stream over either plan's limit:
V <= 2048 at J <= 32 in both dtypes, J <= 32 in f32), and any other
compute dtype, raise, as JAX's kernels take every shape. The
gradient of either kernel is the plain version's autograd on the saved
inputs, as JAX recomputes through its oracles. The decoder
calls :func:`coevo_block` per block under ``whole_block_kernel`` in eval
mode, :func:`coevo_chain` otherwise in eval mode under ``fused``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops.fused_attention import (
    _block_f32_resident,
    _on_card,
    _tensors,
    require_kernel,
    adaln_f32,
    attend,
    coevo_f32_plan,
    coevo_f32_splits,
    mm,
    split_scaled_qkv,
)

CHAIN_LAUNCHES = _cuda.launch_counter("coevo_chain")
BLOCK_LAUNCHES = _cuda.launch_counter("coevo_block")
CHAIN_F32_LAUNCHES = _cuda.launch_counter("coevo_chain_f32")
BLOCK_F32_LAUNCHES = _cuda.launch_counter("coevo_block_f32")

# Order of the per-block AdaLN γ/β slots ([B, NB, 12, C]), as the JAX
# package's ``_COEVO_SLOTS``.
COEVO_SLOTS = (
    "ca_j.normq", "ca_j.normk", "ca_j.normv", "ca_j.norm2",
    "ca_v.normq", "ca_v.normk", "ca_v.normv", "ca_v.norm2",
    "sa_j.norm1", "sa_j.norm2", "sa_v.norm1", "sa_v.norm2",
)


def _heads(a, num_heads):
    B, N, C = a.shape
    return a.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def _merge(o):
    B, H, N, d = o.shape
    return o.transpose(1, 2).reshape(B, N, H * d)


def _attention(q, k, v, num_heads, dt):
    return _merge(attend(_heads(q, num_heads), _heads(k, num_heads),
                         _heads(v, num_heads))).to(dt)


def _ca_ffn(xq, k_in, v_in, g, b, w, num_heads, eps, dt):
    """AdaLN'd cross-attention + FFN; g/b: [B, 4, C] (normq/k/v/norm2).
    Returns the f32 stream."""
    (wq, bq, wk, bk, wv, bv, wproj, bproj, w1, bb1, w2, bb2) = w
    xqf = xq.float()
    nq = adaln_f32(xqf, g[:, None, 0], b[:, None, 0], eps).to(dt)
    nk = adaln_f32(k_in, g[:, None, 1], b[:, None, 1], eps).to(dt)
    nv = adaln_f32(v_in, g[:, None, 2], b[:, None, 2], eps).to(dt)
    scale = 1.0 / math.sqrt(xq.shape[-1] // num_heads)
    q = ((mm(nq, wq.to(dt)) + bq) * scale).to(dt)
    k = (mm(nk, wk.to(dt)) + bk).to(dt)
    v = (mm(nv, wv.to(dt)) + bv).to(dt)
    x1 = xqf + (mm(_attention(q, k, v, num_heads, dt), wproj.to(dt)) + bproj)
    h = adaln_f32(x1, g[:, None, 3], b[:, None, 3], eps).to(dt)
    hh = F.gelu(mm(h, w1.to(dt)) + bb1).to(dt)
    return x1 + (mm(hh, w2.to(dt)) + bb2)


def _sa_ffn(x, g, b, w, num_heads, eps, dt):
    """AdaLN'd self-attention + FFN; g/b: [B, 2, C]. Returns f32."""
    (wqkv, bqkv, wproj, bproj, w1, bb1, w2, bb2) = w
    xf = x.float()
    h1 = adaln_f32(xf, g[:, None, 0], b[:, None, 0], eps).to(dt)
    q, k, v = split_scaled_qkv(mm(h1, wqkv.to(dt)) + bqkv, x.shape[-1],
                               num_heads, dt)
    x1 = xf + (mm(_attention(q, k, v, num_heads, dt), wproj.to(dt)) + bproj)
    h2 = adaln_f32(x1, g[:, None, 1], b[:, None, 1], eps).to(dt)
    hh = F.gelu(mm(h2, w1.to(dt)) + bb1).to(dt)
    return x1 + (mm(hh, w2.to(dt)) + bb2)


def _coevo_block_f32(jf0, vf0, g, b, params, num_heads_j, num_heads_v,
                     eps):
    """One block from its projected features to its two post-SA streams,
    f32 (the chain's heads read these; :func:`coevo_block_plain` rounds
    them)."""
    dt = jf0.dtype
    (jpos, vpos, jQ, vQ, v2jK, j2vK, wv2j, bv2j, wj2v, bj2v,
     ca_j, ca_v, sa_j, sa_v) = params
    jf = (jf0.float() + jpos).to(dt)
    vf = (vf0.float() + vpos).to(dt)
    v_as_j = (mm(vf, wv2j.to(dt)) + bv2j + v2jK).to(dt)
    j_as_v = (mm(jf, wj2v.to(dt)) + bj2v + j2vK).to(dt)
    jq = (jf.float() + jQ).to(dt)
    vq = (vf.float() + vQ).to(dt)
    joint1 = _ca_ffn(jq, v_as_j, vf, g[:, 0:4], b[:, 0:4], ca_j,
                     num_heads_j, eps, dt)
    vertx1 = _ca_ffn(vq, j_as_v, jf, g[:, 4:8], b[:, 4:8], ca_v,
                     num_heads_v, eps, dt)
    joint2 = _sa_ffn(joint1.to(dt), g[:, 8:10], b[:, 8:10], sa_j,
                     num_heads_j, eps, dt)
    vertx2 = _sa_ffn(vertx1.to(dt), g[:, 10:12], b[:, 10:12], sa_v,
                     num_heads_v, eps, dt)
    return joint2, vertx2


def coevo_block_plain(jf0, vf0, gammas, betas, params,
                      num_heads_j: int = 8, num_heads_v: int = 2,
                      eps: float = 1e-6):
    """Plain version of one whole CoevoBlock (``coevo_block_reference``).

    jf0 / vf0: [B, J, C] / [B, V, C] projected features in the compute
    dtype; gammas / betas: [B, 12, C] f32 AdaLN stacks in
    :data:`COEVO_SLOTS` order; ``params``: (joint_pos [J,C], vertx_pos
    [V,C], j_Q, v_Q, v2j_K [V,C], j2v_K [J,C], wv2j, bv2j, wj2v, bj2v, ca_j
    12-tuple, ca_v 12-tuple, sa_j 8-tuple, sa_v 8-tuple) as the JAX package
    packs them. Returns the post-SA (joint_feat, vertx_feat) in jf0's
    dtype."""
    joint2, vertx2 = _coevo_block_f32(jf0, vf0, gammas, betas, params,
                                      num_heads_j, num_heads_v, eps)
    return joint2.to(jf0.dtype), vertx2.to(jf0.dtype)


def coevo_chain_plain(joints, vertx, gammas, betas, blocks,
                      num_heads_j: int = 8, num_heads_v: int = 2,
                      eps: float = 1e-6):
    """Plain version of the whole chain.

    joints / vertx: [B, J, 3] / [B, V, 3] f32 coordinates (meters);
    gammas / betas: [B, NB, 12, C] f32 AdaLN stacks in :data:`COEVO_SLOTS`
    order; ``blocks``: per block (wjp, bjp, wvp, bvp, kparams, whj, bhj,
    whv, bhv), kparams the 14-tuple of :func:`coevo_block_plain`. The
    compute dtype is wjp's. Returns (evo_pose, vertx), f32."""
    evo, vx = joints, vertx
    for blk, (wjp, bjp, wvp, bvp, kp, whj, bhj, whv, bhv) in enumerate(blocks):
        dt = wjp.dtype
        jf0 = (mm(joints.to(dt), wjp) + bjp).to(dt)
        vf0 = (mm(vx.to(dt), wvp) + bvp).to(dt)
        joint2, vertx2 = _coevo_block_f32(jf0, vf0, gammas[:, blk],
                                          betas[:, blk], kp, num_heads_j,
                                          num_heads_v, eps)
        evo = (joint2 @ whj.float() + bhj) + joints
        vx = (vertx2 @ whv.float() + bhv) + vx
    return evo, vx


# Pointer tables: one block's (csrc/coevo_ops.cuh, K_*), and the chain's
# per block (csrc/coevo_chain.cu, P_*): the 3 → C projections, the block's
# table, the coordinate heads.
_BLOCK_TABLE_LEN = 50
_CHAIN_TABLE_LEN = 4 + _BLOCK_TABLE_LEN + 4
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90

# Rows 3 / 14 in bf16 (csrc/coevo_ops.cuh): one CTA a clip while its three
# [V, C] vertex buffers fit in shared memory (V <= 450), else a cluster of S
# CTAs a clip, the vertex rows in tiles of 16 split into S contiguous
# ranges, each rank's buffers of the most rows any rank takes (at most 256:
# two attention tasks a warp), beside them the attention's staging area,
# the joint workspace and the joint CA's partials; S the fewest of 2, 4, 8
# (the portable cluster sizes) whose rank fits in shared memory.
_BF16_SPLITS, _BF16_RANK_ROWS = (2, 4, 8), 256
_BF16_STAGE = 2 * 2 * 64 * 64 * 2  # two stages of a chunk's bf16 k and v
# The clusters of S CTAs a card holds at once, where read on one
# (either library's ``pmce_coevo_clusters`` at J = 17 and 19, V = 431
# and 1723, through ``tools/profile_coevo.py``): {(SMs, S):
# clusters}. NVIDIA H100 80GB HBM3 (132 SMs): one CTA an SM, as rows 3f /
# 14f's, its GPCs leave 30 clusters of 4 and 15 of 8.
_COEVO_CLUSTERS = {(132, 2): 66, (132, 4): 30, (132, 8): 15}


def clip_smem_bytes(V: int) -> int:
    """The one-CTA program's shared memory (``clip_smem_bytes``)."""
    return V * 64 * 8 + 16 * 64 * 2


def clip_workspace_bytes(J: int) -> int:
    """The joint workspace of a clip (``clip_workspace_bytes``)."""
    Jp = -(-J // 16) * 16
    return -(-Jp * (18 * 64 + 2 * 256) // 256) * 256


def _rank_rows_max(V: int, S: int) -> int:
    tiles = -(-V // 16)
    return 16 * -(-tiles // S)


def cluster_smem_bytes(J: int, V: int, S: int) -> int:
    """A cluster rank's shared memory (``cluster_smem_bytes``): three [R,
    C] buffers, the staging area, the joint workspace, the joint CA's
    partial o, max and sum and its merged output."""
    Jp = -(-J // 16) * 16
    return (_rank_rows_max(V, S) * 64 * 8 + _BF16_STAGE
            + clip_workspace_bytes(J) + Jp * 64 * 4 + 2 * Jp * 8 * 4
            + Jp * 64 * 2)


def _bf16_admits(J: int, V: int, S: int) -> bool:
    return (S <= -(-V // 16) and _rank_rows_max(V, S) <= _BF16_RANK_ROWS
            and cluster_smem_bytes(J, V, S) <= _SMEM_LIMIT)


def coevo_splits(J: int, V: int) -> int:
    """S of :func:`coevo_plan` at J joints and V vertices (1: one CTA a
    clip); past the plan's limit ``NotImplementedError`` names it."""
    if clip_smem_bytes(V) <= _SMEM_LIMIT:
        return 1
    for s in _BF16_SPLITS:
        if _bf16_admits(J, V, s):
            return s
    S = _BF16_SPLITS[-1]
    rows = max((r for r in range(16, _BF16_RANK_ROWS + 1, 16)
                if _bf16_admits(J, r * S, S)), default=0)
    raise NotImplementedError(
        f"the bf16 CoevoBlock kernels' plan takes V <= {rows * S} vertices "
        f"at J={J} (clusters of up to {S} CTAs of at most {rows} vertex "
        f"rows in sm_90's {_SMEM_LIMIT} bytes of shared memory), not V={V} "
        "(the JAX kernel takes it); widening it is queued in ROADMAP.md B3")


class CoevoPlan(NamedTuple):
    """Rows 3 / 14's launch in bf16: ``splits`` CTAs a clip (1: one CTA a
    clip; else a cluster, the entry points' S), each rank's vertex rows
    [r0, r1) in rank order, ``ctas`` = B S, a CTA's shared memory
    (``smem``), the ``clusters`` the card holds at once (S = 1: one CTA an
    SM; else read on the card where known, else its SMs // S; None without
    a card) and the ``waves`` of them."""
    splits: int
    rows: tuple
    ctas: int
    smem: int
    clusters: int | None
    waves: int | None


@functools.lru_cache(maxsize=64)
def coevo_plan(B: int, J: int, V: int, sms: int | None) -> CoevoPlan:
    """The launch of ``csrc/coevo_chain.cu`` / ``csrc/coevo_block.cu``
    (bf16) for B clips of J joints and V vertices on a card of ``sms`` SMs
    (None: no card). V over :func:`coevo_splits`' limit raises."""
    if B < 1 or J < 1 or V < 1:
        raise ValueError(f"coevo_plan: {B} x {J} / {V}")
    s = coevo_splits(J, V)
    tiles = -(-V // 16)
    rows = tuple((16 * (tiles * r // s), min(V, 16 * (tiles * (r + 1) // s)))
                 for r in range(s))
    smem = clip_smem_bytes(V) if s == 1 else cluster_smem_bytes(J, V, s)
    if sms is None:
        clusters = waves = None
    else:
        clusters = sms if s == 1 else _COEVO_CLUSTERS.get((sms, s), sms // s)
        waves = -(-B // clusters)
    return CoevoPlan(s, rows, B * s, smem, clusters, waves)


def coevo_kernel_fits(C: int, hid: int, num_heads_j: int, num_heads_v: int,
                      V: int) -> bool:
    """The static shape test of both kernels (whole block, whole chain):
    the widths csrc/coevo_ops.cuh is built for (C = 64, hid = 4C, joint
    heads of width 8 and vertex heads of width 32) and at least 48 vertices
    (MLP tiles of 16 rows or more). The launch then asks the plan
    (:func:`coevo_plan`, :func:`coevo_f32_plan`) and the library for the
    vertex stream's shared memory."""
    return (C == 64 and hid == 4 * C and num_heads_j * 8 == C
            and num_heads_v * 32 == C and V >= 48)


def _require_fits(name, C, hid, num_heads_j, num_heads_v, J, V, lib,
                  smem_fn):
    """The shape gate, then the plan's S (past its V limit
    :func:`coevo_splits` / :func:`coevo_f32_splits` raise, naming it) and
    the library's shared memory at it: the one-CTA program's (``smem_fn``
    at V), a bf16 cluster rank's (at J, V, S) or the f32 plan's CTA (at V,
    S). Returns S."""
    require_kernel(coevo_kernel_fits(C, hid, num_heads_j, num_heads_v, V),
                   name, f"C={C}, hid={hid}, heads {num_heads_j}/"
                   f"{num_heads_v}, V={V}")
    f32 = lib is _cuda.COEVO_F32
    try:
        S = coevo_f32_splits(V) if f32 else coevo_splits(J, V)
    except NotImplementedError as e:
        raise NotImplementedError(f"{name}: {e}") from None
    if f32:
        smem = int(lib.query(smem_fn, V, S))
    elif S == 1:
        smem = int(lib.query(smem_fn, V))
    else:
        smem = int(lib.query("pmce_coevo_cluster_smem_bytes", J, V, S))
    if smem < 0 or smem > _SMEM_LIMIT:
        raise NotImplementedError(
            f"{name}: the CUDA kernel's plan for V={V} needs {smem} bytes of "
            f"shared memory, over sm_90's {_SMEM_LIMIT} (the JAX kernel takes "
            "it); widening it is queued in ROADMAP.md B3")
    return S


def _f32_plan(name, B, J, V, dev):
    """The f32 kernels' cluster launch (:func:`coevo_f32_plan` on the
    card's SMs); a shape it does not take raises, naming its limit."""
    try:
        return coevo_f32_plan(B, J, V, _block_f32_resident(dev))
    except NotImplementedError as e:
        raise NotImplementedError(f"{name}: {e}") from None


def _f32_route(dt, name) -> bool:
    """Whether compute dtype ``dt`` runs the f32 kernels (else the bf16
    ones); any other dtype raises."""
    if dt in (torch.bfloat16, torch.float32):
        return dt == torch.float32
    raise NotImplementedError(
        f"{name} on CUDA takes bf16 or f32 compute, not {dt} (JAX runs "
        "neither f16 nor f64 through its kernel)")


def _require_f32(tree, name):
    """The f32 kernels read every input as f32: a tensor of another dtype
    (bf16 weights beside f32 features, say) raises."""
    for t in _tensors(tree):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: f32 compute takes f32 inputs "
                             f"throughout, got a {t.dtype} tensor of shape "
                             f"{tuple(t.shape)}")


class _Table:
    """Device copies of a kernel's weights and the list of their pointers
    (the tensors stay referenced until the launch is enqueued); ``f32``:
    the f32 kernels' table."""

    def __init__(self, dev, C: int, hid: int, f32: bool = False):
        self.dev, self.C, self.hid, self.f32 = dev, C, hid, f32
        self.keep, self.ptrs = [], []

    def put(self, a, dtype, shape):
        t = _cuda.to_kernel(a, self.dev, dtype, shape, "coevo weight")
        self.keep.append(t)
        self.ptrs.append(t.data_ptr())

    def mat(self, a, rows, cols):
        """A product [rows, cols]. bf16: stored transposed, W^T [cols,
        rows] is the layout of the kernels' B fragments
        (csrc/coevo_ops.cuh). f32: as given, [rows, cols], whose 64 x 64
        blocks the f32 kernels stage as they are (csrc/coevo_f32.cu)."""
        if self.f32:
            self.put(a, torch.float32, (rows, cols))
        else:
            self.put(a.detach().t(), torch.bfloat16, (cols, rows))

    def vec(self, a, *shape):
        self.put(a, torch.float32, shape)

    def pairs(self, *layers):
        """(weight [rows, cols], bias [cols], rows, cols) of dense layers,
        in order."""
        for w, b, rows, cols in layers:
            self.mat(w, rows, cols)
            self.vec(b, cols)

    def embed(self, w, b, cols):
        """A 3 -> cols projection, as given (the chain's embed3 reads it
        [3, cols]), and its bias."""
        self.put(w, torch.float32 if self.f32 else torch.bfloat16,
                 (3, cols))
        self.vec(b, cols)

    def block(self, kp, J, V):
        """One block's K_* entries from its 14-tuple."""
        C, hid = self.C, self.hid
        (jpos, vpos, jQ, vQ, v2jK, j2vK, wv2j, bv2j, wj2v, bj2v,
         ca_j, ca_v, sa_j, sa_v) = kp
        start = len(self.ptrs)
        for a, n in ((jpos, J), (vpos, V), (jQ, J), (vQ, V), (v2jK, V),
                     (j2vK, J)):
            self.vec(a, n, C)
        self.pairs((wv2j, bv2j, C, C), (wj2v, bj2v, C, C))
        for (wq, bq, wk, bk, wv, bv, wproj, bproj, w1, bb1, w2,
             bb2) in (ca_j, ca_v):
            self.pairs((wq, bq, C, C), (wk, bk, C, C), (wv, bv, C, C),
                       (wproj, bproj, C, C), (w1, bb1, C, hid),
                       (w2, bb2, hid, C))
        for (wqkv, bqkv, wproj, bproj, w1, bb1, w2, bb2) in (sa_j, sa_v):
            self.pairs((wqkv, bqkv, C, 3 * C), (wproj, bproj, C, C),
                       (w1, bb1, C, hid), (w2, bb2, hid, C))
        assert len(self.ptrs) - start == _BLOCK_TABLE_LEN

    def device(self):
        """The pointer table on the card, copied from pinned memory without
        waiting: a copy from pageable memory makes the host wait for every
        launch queued before it, and the card then idles while the host
        prepares the rest of the forward."""
        host = torch.tensor(self.ptrs, dtype=torch.int64).pin_memory()
        return host.to(self.dev, non_blocking=True)


def _chain_table(blocks, dev, C, hid, J, V, f32):
    """The chain's pointer table: per block its 3 -> C projections, its
    K_* table and its coordinate heads."""
    tab = _Table(dev, C, hid, f32)
    for (wjp, bjp, wvp, bvp, kp, whj, bhj, whv, bhv) in blocks:
        tab.embed(wjp, bjp, C)
        tab.embed(wvp, bvp, C)
        tab.block(kp, J, V)
        for w, b in ((whj, bhj), (whv, bhv)):
            tab.vec(w, C, 3)
            tab.vec(b, 3)
    assert len(tab.ptrs) == len(blocks) * _CHAIN_TABLE_LEN
    return tab


def _workspace(lib, fn, B, J, S, dev):
    """The bf16 kernels' joint workspace: B clips' in device memory for one
    CTA a clip; none for a cluster (each rank keeps its joint rows in
    shared memory). Returns (the tensor or None, its pointer)."""
    if S > 1:
        return None, _cuda.P(None)
    ws = torch.empty(B * lib.query(fn, J), device=dev, dtype=torch.uint8)
    return ws, _cuda.ptr(ws)


def _require_one_cta(S, what):
    if S > 1:
        raise NotImplementedError(f"the stamped bf16 {what} runs one CTA a "
                                  f"clip (V <= 450), not clusters of {S}")


def _coevo_chain_cuda(joints, vertx, gammas, betas, blocks, num_heads_j,
                      num_heads_v, eps, stamps=None):
    f32 = torch.float32
    use_f32 = _f32_route(blocks[0][0].dtype, "coevo_chain")
    if use_f32:
        _require_f32(blocks, "coevo_chain")
    B, J, _ = joints.shape
    V = vertx.shape[1]
    NB = len(blocks)
    C = gammas.shape[-1]
    hid = blocks[0][4][10][8].shape[1]
    lib, smem_fn = ((_cuda.COEVO_F32, "pmce_coevo_f32_smem_bytes") if use_f32
                    else (_cuda.CHAIN, "pmce_chain_smem_bytes"))
    S = _require_fits("coevo_chain", C, hid, num_heads_j, num_heads_v, J, V,
                      lib, smem_fn)
    _cuda.check_cuda(joints, "joints", f32, (B, J, 3))
    _cuda.check_cuda(vertx, "vertx", f32, (B, V, 3))
    _cuda.check_cuda(gammas, "gammas", f32, (B, NB, 12, C))
    _cuda.check_cuda(betas, "betas", f32, (B, NB, 12, C))
    dev = joints.device
    if use_f32:
        plan = _f32_plan("coevo_chain", B, J, V, dev)
    tab = _chain_table(blocks, dev, C, hid, J, V, use_f32)
    ptrs = tab.device()

    jout = torch.empty(B, J, 3, device=dev, dtype=f32)
    vout = vertx.clone()  # the kernel moves the vertices in place
    p = _cuda.ptr
    scales = (1.0 / math.sqrt(C // num_heads_j),
              1.0 / math.sqrt(C // num_heads_v))
    if use_f32:
        if stamps is not None:
            raise NotImplementedError("the f32 chain has no stamped "
                                      "instantiation")
        lib.call("pmce_coevo_chain_f32", p(joints), p(jout), p(vout),
                 p(gammas), p(betas), p(ptrs), B, J, V, NB, plan.splits, eps,
                 *scales, _cuda.stream_ptr(dev))
        CHAIN_F32_LAUNCHES.count += 1
        return jout, vout
    ws, ws_ptr = _workspace(lib, "pmce_chain_workspace_bytes", B, J, S, dev)
    args = (p(joints), p(jout), p(vout), p(gammas), p(betas), p(ptrs), ws_ptr,
            B, J, V, NB)
    if stamps is not None:
        _require_one_cta(S, "chain")
        _cuda.CHAIN.call("pmce_coevo_chain_prof", *args, eps, *scales,
                         p(stamps), _cuda.stream_ptr(dev))
        return jout, vout
    _cuda.CHAIN.call("pmce_coevo_chain", *args, S, eps, *scales,
                     _cuda.stream_ptr(dev))
    CHAIN_LAUNCHES.count += 1
    return jout, vout


def _coevo_block_cuda(jf0, vf0, gammas, betas, params, num_heads_j,
                      num_heads_v, eps, stamps=None):
    f32 = torch.float32
    use_f32 = _f32_route(jf0.dtype, "coevo_block")
    if use_f32:
        _require_f32((jf0, vf0, params), "coevo_block")
    B, J, C = jf0.shape
    V = vf0.shape[1]
    hid = params[10][8].shape[1]
    lib, smem_fn = ((_cuda.COEVO_F32, "pmce_coevo_f32_smem_bytes") if use_f32
                    else (_cuda.COEVO_BLOCK, "pmce_coevo_block_smem_bytes"))
    S = _require_fits("coevo_block", C, hid, num_heads_j, num_heads_v, J, V,
                      lib, smem_fn)
    _cuda.check_cuda(jf0, "jf0", jf0.dtype, (B, J, C))
    _cuda.check_cuda(vf0, "vf0", jf0.dtype, (B, V, C))
    _cuda.check_cuda(gammas, "gammas", f32, (B, 12, C))
    _cuda.check_cuda(betas, "betas", f32, (B, 12, C))
    dev = jf0.device
    if use_f32:
        plan = _f32_plan("coevo_block", B, J, V, dev)
    tab = _Table(dev, C, hid, use_f32)
    tab.block(params, J, V)
    ptrs = tab.device()

    jout = torch.empty_like(jf0)
    vout = torch.empty_like(vf0)
    p = _cuda.ptr
    scales = (1.0 / math.sqrt(C // num_heads_j),
              1.0 / math.sqrt(C // num_heads_v))
    if use_f32:
        if stamps is not None:
            raise NotImplementedError("the f32 whole block has no stamped "
                                      "instantiation")
        lib.call("pmce_coevo_block_f32", p(jf0), p(vf0), p(jout), p(vout),
                 p(gammas), p(betas), p(ptrs), B, J, V, plan.splits, eps,
                 *scales, _cuda.stream_ptr(dev))
        BLOCK_F32_LAUNCHES.count += 1
        return jout, vout
    ws, ws_ptr = _workspace(lib, "pmce_coevo_block_workspace_bytes", B, J, S,
                            dev)
    args = (p(jf0), p(vf0), p(jout), p(vout), p(gammas), p(betas), p(ptrs),
            ws_ptr, B, J, V)
    if stamps is not None:
        _require_one_cta(S, "whole block")
        _cuda.COEVO_BLOCK.call("pmce_coevo_block_prof", *args, eps, *scales,
                               p(stamps), _cuda.stream_ptr(dev))
        return jout, vout
    _cuda.COEVO_BLOCK.call("pmce_coevo_block", *args, S, eps, *scales,
                           _cuda.stream_ptr(dev))
    BLOCK_LAUNCHES.count += 1
    return jout, vout


def _unflatten(tree, flat):
    """``tree`` with its tensors replaced, depth first, from ``flat``."""
    if isinstance(tree, torch.Tensor):
        return next(flat)
    if isinstance(tree, (tuple, list)):
        return tuple(_unflatten(t, flat) for t in tree)
    return tree


class _RecomputedKernel(torch.autograd.Function):
    """A kernel on the card whose backward is autograd of its plain version
    on the saved inputs, as the JAX package's custom VJPs recompute through
    their XLA oracles (``_chain_bwd``, ``fused_coevo_chain.py:415-431``;
    ``_fused_coevo_bwd``, ``fused_attention.py:2947``): a recompute, not a
    kernel. ``fns`` = (kernel, plain)."""

    @staticmethod
    def forward(ctx, fns, tree, heads, eps, *flat):
        ctx.plain, ctx.tree, ctx.heads, ctx.eps = fns[1], tree, heads, eps
        ctx.save_for_backward(*flat)
        return fns[0](*_unflatten(tree, iter(flat)), *heads, eps)

    @staticmethod
    def backward(ctx, *gouts):
        need = ctx.needs_input_grad[4:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            outs = ctx.plain(*_unflatten(ctx.tree, iter(leaves)), *ctx.heads,
                             ctx.eps)
            grads = iter(torch.autograd.grad(
                outs, [t for t, n in zip(leaves, need) if n], gouts,
                allow_unused=True))
        return (None, None, None, None,
                *(next(grads) if n else None for n in need))


def coevo_chain(joints, vertx, gammas, betas, blocks, num_heads_j: int = 8,
                num_heads_v: int = 2, eps: float = 1e-6):
    """All CoevoBlocks + coordinate heads (args as
    :func:`coevo_chain_plain`). CPU tensors run the plain version; CUDA
    tensors the kernel of the compute dtype (bf16 or f32), with the plain
    version's recompute as its backward (shapes the kernel is not built
    for raise on the card: queued)."""
    if not _on_card(joints, "coevo_chain"):
        return coevo_chain_plain(joints, vertx, gammas, betas, blocks,
                                 num_heads_j, num_heads_v, eps)
    tree = (joints, vertx, gammas, betas, blocks)
    return _RecomputedKernel.apply((_coevo_chain_cuda, coevo_chain_plain),
                                   tree, (num_heads_j, num_heads_v), eps,
                                   *_tensors(tree))


def coevo_block(jf0, vf0, gammas, betas, params, num_heads_j: int = 8,
                num_heads_v: int = 2, eps: float = 1e-6):
    """One whole CoevoBlock (args as :func:`coevo_block_plain`). CPU
    tensors run the plain version; CUDA tensors the kernel of
    ``csrc/coevo_block.cu`` (bf16) or ``csrc/coevo_f32.cu`` (f32), with the
    plain version's recompute as its backward (shapes the kernel is not
    built for raise on the card: queued)."""
    if not _on_card(jf0, "coevo_block"):
        return coevo_block_plain(jf0, vf0, gammas, betas, params,
                                 num_heads_j, num_heads_v, eps)
    tree = (jf0, vf0, gammas, betas, params)
    return _RecomputedKernel.apply((_coevo_block_cuda, coevo_block_plain),
                                   tree, (num_heads_j, num_heads_v), eps,
                                   *_tensors(tree))


# Stage codes of the stamped instantiation (csrc/coevo_ops.cuh, ST_* and
# KD_*): code = stage * 8 + kind.
STAMP_STAGES = ("io", "stage 1", "joint CA", "vertex CA", "joint SA",
                "vertex SA")
STAMP_KINDS = ("other", "gemm", "adaln", "attention", "mlp fc1 + gelu",
               "mlp fc2")


def stamp_split(stamps: torch.Tensor) -> dict:
    """Cycles by (stage, kind) summed over the clips of a stamped launch:
    ``stamps`` is the kernel's [B, MAX_STAMPS, 2] (code, clock64) buffer,
    each interval booked to the code stamped at its end."""
    a = stamps.cpu().numpy()
    split: dict = {}
    for row in a:
        n = int((row[:, 1] != 0).sum())
        for i in range(1, n):
            code, dt = int(row[i, 0]), int(row[i, 1] - row[i - 1, 1])
            key = (STAMP_STAGES[code // 8], STAMP_KINDS[code % 8])
            split[key] = split.get(key, 0) + dt
    return split


def coevo_stage_split(kind: str, *args, num_heads_j: int = 8,
                      num_heads_v: int = 2, eps: float = 1e-6) -> dict:
    """One launch of the stamped instantiation of the chain (``kind`` =
    "chain", args as :func:`coevo_chain_plain`) or of the whole block
    ("block", args as :func:`coevo_block_plain`) on the card; returns
    :func:`stamp_split`. Not counted as a launch of the path."""
    fn = _coevo_chain_cuda if kind == "chain" else _coevo_block_cuda
    B = args[0].shape[0]
    n = int(_cuda.CHAIN.query("pmce_max_stamps"))
    stamps = torch.zeros(B, n, 2, dtype=torch.int64, device=args[0].device)
    with torch.no_grad():
        fn(*args, num_heads_j, num_heads_v, eps, stamps=stamps)
    torch.cuda.synchronize()
    return stamp_split(stamps)
