"""The decoder's whole co-evolution chain, in PyTorch and CUDA.

Port of ``pmce_tpu/ops/fused_coevo_chain.py`` (``fused_coevo_chain``): all
CoevoBlocks plus their f32 coordinate heads. Per block, with the reference
quirks kept: 3 → C projections of the ORIGINAL joints (every block re-reads
them) and of the current vertices; pos, Q and K embeds; the v→j and j→v
projections; joint CA+FFN and vertex CA+FFN, both on the PRE-update streams;
AdaLN'd SA+FFN per stream; f32 C → 3 heads plus residuals.

:func:`coevo_chain_plain` has the math of ``coevo_chain_reference`` and the
``coevo_block_reference`` it calls, with the kernel's cast points (f32 sums
of bf16 products, one rounding each, f32 streams between the residual adds).
:func:`coevo_chain` runs it for CPU tensors and the kernel of
``csrc/coevo_chain.cu`` for CUDA tensors; that kernel takes bf16 compute.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pmce_tpu_torch.ops import _cuda
from pmce_tpu_torch.ops.fused_attention import (
    adaln_f32,
    attend,
    mm,
    split_scaled_qkv,
)

CHAIN_LAUNCHES = _cuda.launch_counter("coevo_chain")

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


def coevo_chain_plain(joints, vertx, gammas, betas, blocks,
                      num_heads_j: int = 8, num_heads_v: int = 2,
                      eps: float = 1e-6):
    """Plain version of the whole chain.

    joints / vertx: [B, J, 3] / [B, V, 3] f32 coordinates (meters);
    gammas / betas: [B, NB, 12, C] f32 AdaLN stacks in :data:`COEVO_SLOTS`
    order; ``blocks``: per block (wjp, bjp, wvp, bvp, kparams, whj, bhj,
    whv, bhv), kparams = (joint_pos [J,C], vertx_pos [V,C], j_Q, v_Q,
    v2j_K [V,C], j2v_K [J,C], wv2j, bv2j, wj2v, bj2v, ca_j 12-tuple, ca_v
    12-tuple, sa_j 8-tuple, sa_v 8-tuple) as the JAX package packs them.
    The compute dtype is wjp's. Returns (evo_pose, vertx), f32."""
    evo, vx = joints, vertx
    for blk, (wjp, bjp, wvp, bvp, kp, whj, bhj, whv, bhv) in enumerate(blocks):
        dt = wjp.dtype
        (jpos, vpos, jQ, vQ, v2jK, j2vK, wv2j, bv2j, wj2v, bj2v,
         ca_j, ca_v, sa_j, sa_v) = kp
        g, b = gammas[:, blk], betas[:, blk]
        jf = ((mm(joints.to(dt), wjp) + bjp).to(dt).float() + jpos).to(dt)
        vf = ((mm(vx.to(dt), wvp) + bvp).to(dt).float() + vpos).to(dt)
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
        evo = (joint2 @ whj.float() + bhj) + joints
        vx = (vertx2 @ whv.float() + bhv) + vx
    return evo, vx


# Per-block pointer table of pmce_coevo_chain (csrc/coevo_chain.cu, P_*).
_TABLE_LEN = 58
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def _coevo_chain_cuda(joints, vertx, gammas, betas, blocks, num_heads_j,
                      num_heads_v, eps):
    bf16, f32 = torch.bfloat16, torch.float32
    if blocks[0][0].dtype != bf16:
        raise NotImplementedError(
            "coevo_chain on CUDA takes bf16 compute; f32 with fused=True on "
            "the card is queued in ROADMAP.md (section B, f32 chain kernel)")
    B, J, _ = joints.shape
    V = vertx.shape[1]
    NB = len(blocks)
    C = gammas.shape[-1]
    hid = blocks[0][4][10][8].shape[1]
    smem = _cuda.CHAIN.query("pmce_chain_smem_bytes", V)
    if (C != 64 or hid != 4 * C or C // num_heads_j != 8
            or C // num_heads_v != 32 or smem > _SMEM_LIMIT or V < 48):
        raise ValueError(f"chain kernel shapes: C={C} hid={hid} "
                         f"heads=({num_heads_j}, {num_heads_v}) V={V}")
    _cuda.check_cuda(joints, "joints", f32, (B, J, 3))
    _cuda.check_cuda(vertx, "vertx", f32, (B, V, 3))
    _cuda.check_cuda(gammas, "gammas", f32, (B, NB, 12, C))
    _cuda.check_cuda(betas, "betas", f32, (B, NB, 12, C))
    dev = joints.device
    keep = []  # the tensors the pointer table points into

    def put(a, dtype, shape):
        t = _cuda.to_kernel(a, dev, dtype, shape, "chain weight")
        keep.append(t)
        return t.data_ptr()

    def mat(a, rows, cols):
        return put(a, bf16, (rows, cols))

    def vec(a, *shape):
        return put(a, f32, shape)

    def ca(w):
        (wq, bq, wk, bk, wv, bv, wproj, bproj, w1, bb1, w2, bb2) = w
        return [mat(wq, C, C), vec(bq, C), mat(wk, C, C), vec(bk, C),
                mat(wv, C, C), vec(bv, C), mat(wproj, C, C), vec(bproj, C),
                mat(w1, C, hid), vec(bb1, hid), mat(w2, hid, C), vec(bb2, C)]

    def sa(w):
        (wqkv, bqkv, wproj, bproj, w1, bb1, w2, bb2) = w
        return [mat(wqkv, C, 3 * C), vec(bqkv, 3 * C), mat(wproj, C, C),
                vec(bproj, C), mat(w1, C, hid), vec(bb1, hid),
                mat(w2, hid, C), vec(bb2, C)]

    table = []
    for (wjp, bjp, wvp, bvp, kp, whj, bhj, whv, bhv) in blocks:
        (jpos, vpos, jQ, vQ, v2jK, j2vK, wv2j, bv2j, wj2v, bj2v,
         ca_j, ca_v, sa_j, sa_v) = kp
        row = [mat(wjp, 3, C), vec(bjp, C), mat(wvp, 3, C), vec(bvp, C),
               vec(jpos, J, C), vec(vpos, V, C), vec(jQ, J, C),
               vec(vQ, V, C), vec(v2jK, V, C), vec(j2vK, J, C),
               mat(wv2j, C, C), vec(bv2j, C), mat(wj2v, C, C), vec(bj2v, C)]
        row += ca(ca_j) + ca(ca_v) + sa(sa_j) + sa(sa_v)
        row += [vec(whj, C, 3), vec(bhj, 3), vec(whv, C, 3), vec(bhv, 3)]
        assert len(row) == _TABLE_LEN
        table += row
    ptrs = torch.tensor(table, dtype=torch.int64, device=dev)

    jout = torch.empty(B, J, 3, device=dev, dtype=f32)
    vout = vertx.clone()  # the kernel moves the vertices in place
    ws_bytes = _cuda.CHAIN.query("pmce_chain_workspace_bytes", J)
    ws = torch.empty(B * ws_bytes, device=dev, dtype=torch.uint8)
    p = _cuda.ptr
    _cuda.CHAIN.call(
        "pmce_coevo_chain", p(joints), p(jout), p(vout), p(gammas), p(betas),
        p(ptrs), p(ws), B, J, V, NB, eps,
        1.0 / math.sqrt(C // num_heads_j), 1.0 / math.sqrt(C // num_heads_v),
        _cuda.stream_ptr(dev))
    CHAIN_LAUNCHES.count += 1
    return jout, vout


def coevo_chain(joints, vertx, gammas, betas, blocks, num_heads_j: int = 8,
                num_heads_v: int = 2, eps: float = 1e-6):
    """All CoevoBlocks + coordinate heads (args as
    :func:`coevo_chain_plain`)."""
    if joints.device.type == "cpu":
        return coevo_chain_plain(joints, vertx, gammas, betas, blocks,
                                 num_heads_j, num_heads_v, eps)
    if joints.device.type != "cuda":
        raise ValueError(f"coevo_chain: unsupported device {joints.device}")
    return _coevo_chain_cuda(joints, vertx, gammas, betas, blocks,
                             num_heads_j, num_heads_v, eps)
