"""Carry weights from the JAX package's models into the port.

:func:`state_dict_from_jax` turns a JAX PMCE parameter tree (nested dicts of
arrays, as ``PMCE.init`` or a checkpoint gives them) into the port's
reference-named state_dict. It is the inverse of
``tools/import_torch_checkpoint.import_pmce``.
:func:`lifter_state_dict_from_jax` does the same for a bare Stage-1
``PoseLifter``. Layout rules:

- a torch ``Linear.weight`` is [out, in], a flax ``Dense.kernel`` [in, out];
- the upsample ``Conv1d.weight`` is [out, in, k] in torch, [k, in, out] in
  flax;
- the frame fusion ``Conv2d.weight`` is [1, T, 1, 1] in torch, the flax
  ``fusion_weight`` [T];
- LayerNorm ``weight`` is flax's ``scale``; GRU ``weight_ih_l{k}[_reverse]``
  is the transposed ``l{k}_{fwd,bwd}.ih.kernel``.

The demo's models (:func:`resnet50_state_dict_from_jax`,
:func:`hmr_state_dict_from_jax`, :func:`vitpose_state_dict_from_jax`,
:func:`detector_state_dict_from_jax`) invert
``tools/import_backbones.py``'s ``_conv``, ``_deconv`` and ``_bn``:

- a flax ``Conv`` kernel [kh, kw, in, out] is a torch ``Conv2d.weight``
  [out, in, kh, kw]; a ``ConvTranspose(transpose_kernel=True)`` kernel
  [kh, kw, out, in] a ``ConvTranspose2d.weight`` [in, out, kh, kw]: both
  the same axis permutation;
- ``BatchNorm`` scale / bias → weight / bias, the batch statistics'
  mean / var → running_mean / running_var;
- mmpose's ``pos_embed`` keeps a leading cls slot that the JAX model drops:
  it comes back as zeros.
"""

from __future__ import annotations

import numpy as np
import torch


def _arr(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(p, name, out):
    out[f"{name}.weight"] = _arr(np.asarray(p["kernel"]).T)
    out[f"{name}.bias"] = _arr(p["bias"])


def _ln(p, name, out):
    out[f"{name}.weight"] = _arr(p["scale"])
    out[f"{name}.bias"] = _arr(p["bias"])


def _adaln(p, name, out):
    _dense(p["mlp_gamma"], f"{name}.mlp_gamma", out)
    _dense(p["mlp_beta"], f"{name}.mlp_beta", out)


def _attn(p, name, out):
    _dense(p["qkv"], f"{name}.qkv", out)
    _dense(p["proj"], f"{name}.proj", out)


def _mlp(p, name, out):
    _dense(p["fc1"], f"{name}.fc1", out)
    _dense(p["fc2"], f"{name}.fc2", out)


def _block(p, name, out):
    _ln(p["norm1"], f"{name}.norm1", out)
    _attn(p["attn"], f"{name}.attn", out)
    _ln(p["norm2"], f"{name}.norm2", out)
    _mlp(p["mlp"], f"{name}.mlp", out)


def _ada_block(p, name, out):
    _adaln(p["norm1"], f"{name}.norm1", out)
    _attn(p["attn"], f"{name}.attn", out)
    _adaln(p["norm2"], f"{name}.norm2", out)
    _mlp(p["mlp"], f"{name}.mlp", out)


def _ca_block(p, name, out):
    for n in ("normq", "normk", "normv", "norm2"):
        _adaln(p[n], f"{name}.{n}", out)
    for n in ("wq", "wk", "wv", "proj"):
        _dense(p["attn"][n], f"{name}.attn.{n}", out)
    _mlp(p["mlp"], f"{name}.mlp", out)


def _pose_lifter(p, name, out):
    _dense(p["joint_embed"], f"{name}.joint_embed", out)
    _dense(p["imgfeat_embed"], f"{name}.imgfeat_embed", out)
    out[f"{name}.spatial_pos_embed"] = _arr(p["spatial_pos_embed"])
    out[f"{name}.temporal_pos_embed"] = _arr(p["temporal_pos_embed"])
    depth = sum(1 for k in p if k.startswith("spatial_block"))
    for i in range(depth):
        _block(p[f"spatial_block{i}"], f"{name}.SpatialBlocks.{i}", out)
        _block(p[f"temporal_block{i}"], f"{name}.TemporalBlocks.{i}", out)
    _ln(p["norm_s"], f"{name}.norm_s", out)
    _ln(p["norm_t"], f"{name}.norm_t", out)
    _ln(p["head_norm"], f"{name}.regression.0", out)
    _dense(p["head_proj"], f"{name}.regression.1", out)
    fw = np.asarray(p["fusion_weight"])
    out[f"{name}.fusion.weight"] = _arr(fw.reshape(1, fw.shape[0], 1, 1))
    out[f"{name}.fusion.bias"] = _arr(np.asarray(p["fusion_bias"]).reshape(1))


def _gru(p, name, out):
    layers = sum(1 for k in p if k.endswith("_fwd"))
    for layer in range(layers):
        for sfx, tag in (("", "fwd"), ("_reverse", "bwd")):
            cell = p[f"l{layer}_{tag}"]
            for kind in ("ih", "hh"):
                out[f"{name}.weight_{kind}_l{layer}{sfx}"] = _arr(
                    np.asarray(cell[kind]["kernel"]).T)
                out[f"{name}.bias_{kind}_l{layer}{sfx}"] = _arr(
                    cell[kind]["bias"])


def _coevo_block(p, name, out):
    for n in ("joint_proj", "vertx_proj", "proj_v2j_dim", "proj_j2v_dim",
              "proj_joint_feat2coor", "proj_vertx_feat2coor"):
        _dense(p[n], f"{name}.{n}", out)
    for n in ("joint_pos_embed", "vertx_pos_embed", "j_Q_embed", "v_Q_embed",
              "v2j_K_embed", "j2v_K_embed"):
        out[f"{name}.{n}"] = _arr(p[n])
    _ca_block(p["joint_CA_FFN"], f"{name}.joint_CA_FFN", out)
    _ca_block(p["vertx_CA_FFN"], f"{name}.vertx_CA_FFN", out)
    _ada_block(p["joint_SA_FFN"], f"{name}.joint_SA_FFN", out)
    _ada_block(p["vertx_SA_FFN"], f"{name}.vertx_SA_FFN", out)


def _decoder(p, name, out):
    _gru(p["gru_cur"], f"{name}.gru_cur", out)
    blocks = sum(1 for k in p if k.startswith("coevoblock"))
    for i in range(1, blocks + 1):
        _coevo_block(p[f"coevoblock{i}"], f"{name}.coevoblock{i}", out)
    out[f"{name}.upsample_conv.weight"] = _arr(
        np.asarray(p["upsample_conv"]["kernel"]).transpose(2, 1, 0))
    out[f"{name}.upsample_conv.bias"] = _arr(p["upsample_conv"]["bias"])
    for i in (1, 2, 3):
        _dense(p[f"linear_cur{i}"], f"{name}.linear_cur{i}", out)


def state_dict_from_jax(params, vj_relation=None) -> dict:
    """JAX PMCE params → the port's state_dict (CPU f32 tensors).

    ``params`` is the tree under ``"params"`` (or the whole variables dict).
    With ``vj_relation`` the decoder's ``vj_relation`` buffer is included,
    so the result loads with ``load_state_dict(strict=True)``."""
    if "params" in params:
        params = params["params"]
    out: dict = {}
    _pose_lifter(params["pose_lifter"], "pose_lifter", out)
    _decoder(params["pose_mesh_coevo"], "pose_mesh_coevo", out)
    if vj_relation is not None:
        out["pose_mesh_coevo.vj_relation"] = torch.as_tensor(
            np.asarray(vj_relation), dtype=torch.long)
    return out


def lifter_state_dict_from_jax(params) -> dict:
    """JAX ``PoseLifter`` params (a bare lifter, as Stage-1 training holds
    it) → the state_dict of the port's ``PoseLifter``."""
    if "params" in params:
        params = params["params"]
    out: dict = {}
    _pose_lifter(params, "lifter", out)
    return {k[len("lifter."):]: v for k, v in out.items()}


# ------------------------------------------------------- the demo's models
def _conv(p, name, out):
    out[f"{name}.weight"] = _arr(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        out[f"{name}.bias"] = _arr(p["bias"])


def _bn(p, stats, name, out):
    _ln(p, name, out)
    out[f"{name}.running_mean"] = _arr(stats["mean"])
    out[f"{name}.running_var"] = _arr(stats["var"])
    out[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _resnet(p, s, out):
    _conv(p["conv1"], "conv1", out)
    _bn(p["bn1"], s["bn1"], "bn1", out)
    for key in sorted(k for k in p if k.startswith("layer")):
        stage, b = key[len("layer"):].split("_")
        dst = f"layer{stage}.{b}"
        for i in (1, 2, 3):
            _conv(p[key][f"conv{i}"], f"{dst}.conv{i}", out)
            _bn(p[key][f"bn{i}"], s[key][f"bn{i}"], f"{dst}.bn{i}", out)
        if "down_conv" in p[key]:
            _conv(p[key]["down_conv"], f"{dst}.downsample.0", out)
            _bn(p[key]["down_bn"], s[key]["down_bn"], f"{dst}.downsample.1",
                out)


def resnet50_state_dict_from_jax(variables) -> dict:
    """JAX ``ResNet50`` variables ({"params", "batch_stats"}) → the
    port's ``ResNet50`` state_dict (torchvision names)."""
    out: dict = {}
    _resnet(variables["params"], variables["batch_stats"], out)
    return out


def hmr_state_dict_from_jax(variables) -> dict:
    """JAX ``HMR`` variables → the port's ``HMR`` state_dict (SPIN names:
    the regressor's layers beside the trunk's)."""
    out: dict = {}
    p = variables["params"]
    _resnet(p["backbone"], variables["batch_stats"]["backbone"], out)
    for name in ("fc1", "fc2", "decpose", "decshape", "deccam"):
        _dense(p["regressor"][name], name, out)
    return out


def vitpose_state_dict_from_jax(variables) -> dict:
    """JAX ``ViTPose`` variables → the port's ``ViTPose`` state_dict
    (mmpose names)."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict = {}
    _conv(p["patch_embed"], "backbone.patch_embed.proj", out)
    pos = np.asarray(p["pos_embed"])
    out["backbone.pos_embed"] = _arr(np.concatenate(
        [np.zeros_like(pos[:, :1]), pos], axis=1))
    depth = sum(1 for k in p if k.startswith("block"))
    for i in range(depth):
        _block(p[f"block{i}"], f"backbone.blocks.{i}", out)
    _ln(p["norm"], "backbone.last_norm", out)
    for j, idx in enumerate((0, 3)):
        _conv(p[f"deconv{j}"], f"keypoint_head.deconv_layers.{idx}", out)
        _bn(p[f"deconv_bn{j}"], s[f"deconv_bn{j}"],
            f"keypoint_head.deconv_layers.{idx + 1}", out)
    _conv(p["final"], "keypoint_head.final_layer", out)
    return out


def detector_state_dict_from_jax(params) -> dict:
    """JAX ``PersonDetector`` params → the port's ``PersonDetector``
    state_dict."""
    if "params" in params:
        params = params["params"]
    out: dict = {}
    n_blocks = sum(1 for k in params if k.startswith("ConvBlock_"))
    for i in range(n_blocks):
        blk = params[f"ConvBlock_{i}"]
        _conv(blk["Conv_0"], f"blocks.{i}.conv", out)
        _ln(blk["GroupNorm_0"], f"blocks.{i}.norm", out)
    for name in ("head_heat", "head_size", "head_off"):
        _conv(params[name], name, out)
    return out
