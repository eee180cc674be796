"""Stage-2 pose ↔ mesh co-evolution decoder.

Port of ``pmce_tpu/models/coevo.py``; parameter names are those of the
reference ``Pose2Mesh`` / ``CoevoBlock``. A 2-layer BiGRU over the T image
features gives the mid-frame condition (2H wide) for every AdaLayerNorm and
the residual heads; the coarse vertices start at their nearest template
joint (a static gather); three CoevoBlocks run joint ↔ vertex
cross-attention and per-stream self-attention; an f32 431 → 6890 upsample
(the Conv1d over the xyz axis, as one GEMM) plus three per-axis residual
heads give the mesh.

Reference quirks kept: every CoevoBlock consumes the ORIGINAL lifted joints
(only the vertices chain), and both cross-attentions read the PRE-update
features of the other stream.

With ``fused`` in eval mode (the JAX package's ``deterministic``) the three
blocks and their heads are one call of
:func:`~pmce_tpu_torch.ops.fused_coevo_chain.coevo_chain` (a kernel on the
card), fed the per-clip AdaLN γ/β computed here with dense products. With
``fused`` and ``whole_block_kernel`` in eval mode each block is instead one
call of :func:`~pmce_tpu_torch.ops.fused_coevo_chain.coevo_block` (a kernel
per block on the card) between its dense 3 → C projections and its f32
heads, as ``pmce_tpu/models/coevo.py:111-115, 204-227, 284-286`` gates it;
the parameters are the same either way. In training mode the blocks run one
by one with stochastic depth; under ``fused`` each attention block takes its
kernel gate (``ada_block``, ``ca_block``, ``fused_mhsa``: kernels forward
and backward on the card), as ``pmce_tpu/models/coevo.py:304-307`` does.
The gather of the coarse vertices from their joints has a fixed-order
gradient (:func:`~pmce_tpu_torch.ops.segments.gather_rows`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pmce_tpu_torch.models.layers import (
    AdaBlock,
    BiGRU,
    CrossAttentionBlock,
    dense,
    init_like_jax,
    linear_t,
)
from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.ops import fused_coevo_chain as fc
from pmce_tpu_torch.ops.segments import gather_rows, segment_table


class CoevoBlock(nn.Module):
    """One co-evolution step between the joint and vertex token streams."""

    def __init__(self, num_joint: int, num_vertx: int, joint_dim: int = 64,
                 vertx_dim: int = 64, cond_dim: int = 2048,
                 joint_heads: int = 8, vertx_heads: int = 2,
                 mlp_ratio: float = 4.0, drop_path: float = 0.2,
                 whole_block_kernel: bool = False):
        super().__init__()
        self.whole_block_kernel = whole_block_kernel
        self.joint_heads = joint_heads
        self.vertx_heads = vertx_heads
        self.joint_proj = nn.Linear(3, joint_dim)
        self.vertx_proj = nn.Linear(3, vertx_dim)
        self.joint_pos_embed = nn.Parameter(
            torch.randn(1, num_joint, joint_dim))
        self.vertx_pos_embed = nn.Parameter(
            torch.randn(1, num_vertx, vertx_dim))
        self.j_Q_embed = nn.Parameter(torch.randn(1, num_joint, joint_dim))
        self.v_Q_embed = nn.Parameter(torch.randn(1, num_vertx, vertx_dim))
        self.proj_v2j_dim = nn.Linear(vertx_dim, joint_dim)
        self.proj_j2v_dim = nn.Linear(joint_dim, vertx_dim)
        self.v2j_K_embed = nn.Parameter(torch.randn(1, num_vertx, joint_dim))
        self.j2v_K_embed = nn.Parameter(torch.randn(1, num_joint, vertx_dim))
        self.joint_SA_FFN = AdaBlock(joint_dim, joint_heads, mlp_ratio,
                                     drop_path=drop_path, cond_dim=cond_dim)
        self.vertx_SA_FFN = AdaBlock(vertx_dim, vertx_heads, mlp_ratio,
                                     drop_path=drop_path, cond_dim=cond_dim)
        self.joint_CA_FFN = CrossAttentionBlock(
            joint_dim, joint_dim, vertx_dim, joint_heads, mlp_ratio,
            drop_path=drop_path, cond_dim=cond_dim)
        self.vertx_CA_FFN = CrossAttentionBlock(
            vertx_dim, vertx_dim, joint_dim, vertx_heads, mlp_ratio,
            drop_path=drop_path, cond_dim=cond_dim)
        self.proj_joint_feat2coor = nn.Linear(joint_dim, 3)
        self.proj_vertx_feat2coor = nn.Linear(vertx_dim, 3)

    def forward(self, joint, vertx, cond, dt=None, generator=None,
                fused: bool = False):
        """joint [B, J, 3], vertx [B, V, 3], cond [B, 2H] → both updated.
        In training mode the four blocks draw their stochastic depth from
        ``generator`` (a generator on the inputs' device); ``fused`` goes to
        each of them. With ``fused`` and ``whole_block_kernel`` in eval mode
        (and equal stream widths) the block is one
        :func:`~pmce_tpu_torch.ops.fused_coevo_chain.coevo_block` call."""
        # One node for this block's uses of cond: their gradients are
        # summed here before they join the other blocks' and the heads',
        # the order an FSDP unit boundary imposes, so that one device and
        # FSDP sum them alike (bit for bit under bf16).
        cond = cond.view_as(cond)
        joint_feat = dense(joint, self.joint_proj, dt)
        vertx_feat = dense(vertx, self.vertx_proj, dt)
        if (fused and self.whole_block_kernel and not self.training
                and self.joint_proj.out_features
                == self.vertx_proj.out_features):
            gammas, betas, kparams = self.block_pack(cond, dt)
            joint_new, vertx_new = fc.coevo_block(
                joint_feat, vertx_feat, gammas, betas, kparams,
                self.joint_heads, self.vertx_heads)
        else:
            joint_feat = joint_feat + self.joint_pos_embed
            vertx_feat = vertx_feat + self.vertx_pos_embed
            v_as_j = dense(vertx_feat, self.proj_v2j_dim, dt)
            j_as_v = dense(joint_feat, self.proj_j2v_dim, dt)
            joint_new = self.joint_CA_FFN(
                joint_feat + self.j_Q_embed, v_as_j + self.v2j_K_embed,
                vertx_feat, cond, dt, generator, fused)
            vertx_new = self.vertx_CA_FFN(
                vertx_feat + self.v_Q_embed, j_as_v + self.j2v_K_embed,
                joint_feat, cond, dt, generator, fused)
            joint_new = self.joint_SA_FFN(joint_new, cond, dt, generator,
                                          fused)
            vertx_new = self.vertx_SA_FFN(vertx_new, cond, dt, generator,
                                          fused)
        # f32 coordinate heads: meter-scale outputs.
        joint_out = (F.linear(joint_new.float(),
                              self.proj_joint_feat2coor.weight,
                              self.proj_joint_feat2coor.bias)
                     + joint[..., :3].float())
        vertx_out = (F.linear(vertx_new.float(),
                              self.proj_vertx_feat2coor.weight,
                              self.proj_vertx_feat2coor.bias)
                     + vertx[..., :3].float())
        return joint_out, vertx_out

    def block_pack(self, cond, dt):
        """(γ [B, 12, C], β [B, 12, C], the block's 14-tuple) for
        :func:`~pmce_tpu_torch.ops.fused_coevo_chain.coevo_block`; γ/β in
        its slot order (``COEVO_SLOTS``), regressed in the compute dtype,
        then f32."""
        norms = (self.joint_CA_FFN.adaln() + self.vertx_CA_FFN.adaln()
                 + self.joint_SA_FFN.adaln() + self.vertx_SA_FFN.adaln())
        gb = [n.gamma_beta(cond, dt) for n in norms]
        gammas = torch.stack([g for g, _ in gb], dim=1).float()
        betas = torch.stack([b for _, b in gb], dim=1).float()
        kparams = (self.joint_pos_embed[0], self.vertx_pos_embed[0],
                   self.j_Q_embed[0], self.v_Q_embed[0],
                   self.v2j_K_embed[0], self.j2v_K_embed[0],
                   *linear_t(self.proj_v2j_dim), *linear_t(self.proj_j2v_dim),
                   self.joint_CA_FFN.params(), self.vertx_CA_FFN.params(),
                   self.joint_SA_FFN.params(), self.vertx_SA_FFN.params())
        return gammas, betas, kparams

    def chain_pack(self, cond, dt):
        """(γ, β, the block's chain tuple) for
        :func:`~pmce_tpu_torch.ops.fused_coevo_chain.coevo_chain`: the
        :meth:`block_pack` with the 3 → C projections (in the compute
        dtype) and the coordinate heads around it."""
        gammas, betas, kparams = self.block_pack(cond, dt)
        cd = dt or torch.float32
        wjp, bjp = linear_t(self.joint_proj)
        wvp, bvp = linear_t(self.vertx_proj)
        block = (wjp.to(cd), bjp, wvp.to(cd), bvp, kparams,
                 *linear_t(self.proj_joint_feat2coor),
                 *linear_t(self.proj_vertx_feat2coor))
        return gammas, betas, block


class CoevolutionDecoder(nn.Module):
    """Lifted pose (meters) + image features → (evo_pose, mesh), meters."""

    def __init__(self, num_joint: int, vj_relation, num_vertx: int = 431,
                 num_verts_full: int = 6890, joint_dim: int = 64,
                 vertx_dim: int = 64, gru_hidden: int = 1024,
                 seqlen: int = 16, num_blocks: int = 3, dtype=None,
                 fused: bool = False, whole_block_kernel: bool = False):
        super().__init__()
        self.seqlen = seqlen
        self.dtype = dtype
        self.fused = fused
        self.whole_block_kernel = whole_block_kernel
        self.register_buffer(
            "vj_relation", torch.as_tensor(vj_relation, dtype=torch.long))
        # Each joint's coarse vertices: the gather's fixed-order gradient.
        self.register_buffer("vj_table",
                             segment_table(vj_relation, num_joint),
                             persistent=False)
        cond_dim = 2 * gru_hidden
        for i in range(1, num_blocks + 1):
            self.add_module(f"coevoblock{i}", CoevoBlock(
                num_joint, num_vertx, joint_dim, vertx_dim, cond_dim,
                whole_block_kernel=whole_block_kernel))
        self.num_blocks = num_blocks
        self.upsample_conv = nn.Conv1d(num_vertx, num_verts_full,
                                       kernel_size=3, padding=1)
        self.gru_cur = BiGRU(2048, gru_hidden, num_layers=2)
        for i in (1, 2, 3):
            self.add_module(f"linear_cur{i}",
                            nn.Linear(cond_dim, num_verts_full))

    def blocks(self):
        return [getattr(self, f"coevoblock{i}")
                for i in range(1, self.num_blocks + 1)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initial values, drawn from ``generator`` (a CPU
        generator): the pos, Q and K embeds N(0, 1), the rest as
        :func:`~pmce_tpu_torch.models.layers.init_like_jax`."""
        for name, p in self.named_parameters():
            if name.endswith("_embed"):
                p.copy_(torch.randn(tuple(p.shape), generator=generator))
            else:
                init_like_jax(p, name, generator)

    def forward(self, joints, img_feats, generator=None):
        """joints [B, J, 3] (m), img_feats [B, T, 2048] → (evo_pose
        [B, J, 3], mesh [B, 6890, 3]), f32 meters. In training mode the
        blocks' stochastic depth draws from ``generator``."""
        B = joints.shape[0]
        dt = self.dtype
        cond = self.gru_cur(img_feats.transpose(0, 1),
                            mid_index=self.seqlen // 2, dt=dt)   # [B, 2H]
        vertx = gather_rows(joints[..., :3], self.vj_relation, self.vj_table)
        blocks = self.blocks()
        if (self.fused and not self.training and not self.whole_block_kernel
                and blocks[0].joint_proj.out_features
                == blocks[0].vertx_proj.out_features):
            packs = [blk.chain_pack(cond, dt) for blk in blocks]
            evo_pose, vertx = fc.coevo_chain(
                joints.float(), vertx.float().contiguous(),
                torch.stack([p[0] for p in packs], dim=1),
                torch.stack([p[1] for p in packs], dim=1),
                tuple(p[2] for p in packs), blocks[0].joint_heads,
                blocks[0].vertx_heads)
        else:
            evo_pose = joints
            for blk in blocks:
                evo_pose, vertx = blk(joints, vertx, cond, dt, generator,
                                      self.fused)

        # Conv1d(V → 6890, k=3, pad 1) over the xyz axis as one f32 GEMM:
        # out[i] = Σ_k x_pad[i + k] · W[k], x_pad = (0, x, y, z, 0).
        vf = vertx.float()
        x0, x1, x2 = vf[..., 0], vf[..., 1], vf[..., 2]            # [B, V]
        z = torch.zeros_like(x0)
        x3 = torch.stack([torch.cat([z, x0, x1], dim=-1),
                          torch.cat([x0, x1, x2], dim=-1),
                          torch.cat([x1, x2, z], dim=-1)], dim=1)  # [B,3,3V]
        w = self.upsample_conv.weight                               # [O, V, 3]
        wf = w.permute(2, 1, 0).reshape(-1, w.shape[0])             # [3V, O]
        mesh = (x3.reshape(B * 3, -1) @ wf + self.upsample_conv.bias)
        mesh = mesh.reshape(B, 3, -1).transpose(1, 2)               # [B,O,3]

        # Per-axis residuals from the ReLU'd condition: products of the
        # compute-dtype operands, summed and emitted in f32.
        feat = F.relu(cond)
        res = []
        for i in (1, 2, 3):
            lin = getattr(self, f"linear_cur{i}")
            if dt is None:
                res.append(F.linear(feat, lin.weight, lin.bias))
            else:
                res.append(fa.mm(feat.to(dt), lin.weight.t().to(dt))
                           + lin.bias)
        out = mesh + torch.stack(res, dim=-1)
        return evo_pose.float(), out.float()
