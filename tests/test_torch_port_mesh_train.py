"""Stage-2 PMCE mesh training in the port against the JAX package, on the CPU.

Small sizes: a V = 600 synthetic body coarsened (600, 150, 40), embed 32,
depth 1, GRU hidden 32, joint/vertex width 64, batch 8 (so that JAX's GRU
kernel gate, bf16 and B % 8 == 0, holds). Weights, inputs and cotangents
come from numpy with a seed and go to both sides.

- the training GRU (kernel table rows 12 and 13): the plain saving forward
  and backward scan, forward and reverse, against JAX's Pallas pair run
  through ``jax.vjp`` of ``fused_gru_layer`` / ``fused_gru_layer_rev``
  (interpreted); in f32 within 2e-4, the bound of
  ``tests/test_fused_attention.py::test_fused_gru_layer_gradients``; in
  bf16 within a pinned band;
- the BiGRU's gradients against JAX's, f32 and bf16;
- the face-loss Function against autograd of the plain losses and against
  JAX's ``build_face_losses``, value and gradient, within the bounds of
  ``tests/test_losses.py::test_fused_face_losses_match``;
- ``pmce_total_loss`` term by term against JAX (1e-5 relative);
- the whole deterministic PMCE loss and gradients against
  ``jax.value_and_grad`` in f32: the loss within 1e-5 relative, every
  gradient within 1e-4 of its largest magnitude;
- the PMCE eval step against ``make_pmce_eval_step`` (1e-5 relative);
- a small ``Trainer.fit`` of PMCE with the edge gate switching on, restore,
  and the Stage-1 → Stage-2 warm start;
- the repairs of this slice: the BiGRU takes the GRU kernel path under
  bf16 whatever ``fused`` says, and the fused decoder runs its chain only
  in eval mode.
"""

from __future__ import annotations

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.core import losses as jlosses
from pmce_tpu.core.trainer import make_pmce_eval_step as jax_eval_step
from pmce_tpu.models.layers import BiGRU as JaxBiGRU
from pmce_tpu.models.pmce import PMCE as JaxPMCE
from pmce_tpu.ops import fused_attention as jfa
from pmce_tpu_torch import convert
from pmce_tpu_torch.core import checkpoint as ckpt_lib
from pmce_tpu_torch.core import losses
from pmce_tpu_torch.core.config import Config
from pmce_tpu_torch.core.trainer import Trainer, make_pmce_eval_step, pmce_loss
from pmce_tpu_torch.data.clip_dataset import ClipDataset, MultiDataset
from pmce_tpu_torch.data.synthetic import generate_sequences
from pmce_tpu_torch.models.layers import BiGRU
from pmce_tpu_torch.models.pmce import PMCE, load_lifter_checkpoint
from pmce_tpu_torch.models.pose_lifter import create_pose_lifter
from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.ops import fused_coevo_chain as fc
from pmce_tpu_torch.smpl.artifacts import synthetic_artifacts

from torch_port_common import (
    init_shapes,
    numpy_params,
    perturbed_init,
    rel_max_err,
)

T, J, B, V, NV = 16, 17, 8, 600, 40
CFG = dict(embed_dim=32, depth=1, num_vertx=NV, num_verts_full=V,
           joint_dim=64, vertx_dim=64, gru_hidden=32, seqlen=T)
WEIGHTS = (0.1, 20.0, 1e-3)   # MODEL normal / edge / joint loss weights
VJ = tuple(i % J for i in range(NV))


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype) \
        .requires_grad_(grad)


def _grad_err(want, got) -> float:
    """max|got - want| over the largest magnitude of want."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = np.abs(want).max()
    assert scale > 0, "degenerate reference gradient"
    return float(np.abs(got - want).max() / scale)


# ---------------------------------------------------------- training GRU
def _gru_case(seed, steps=6, H=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(steps, B, 3 * H)).astype(np.float32),
            (rng.normal(size=(H, 3 * H)) * 0.2).astype(np.float32),
            (rng.normal(size=(3 * H,)) * 0.2).astype(np.float32),
            rng.normal(size=(steps, B, H)).astype(np.float32))


def _one_row(cot, row):
    """A cotangent at one row only, as the mid-frame layer's [-1] / [0]."""
    out = np.zeros_like(cot)
    out[row] = cot[row]
    return out


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("rows", ["all", "one"])
def test_gru_training_pair_matches_jax_f32(reverse, rows):
    gi, whh, bhh, cot = _gru_case(1 + reverse)
    if rows == "one":
        cot = _one_row(cot, 0 if reverse else -1)
    jk = jfa.fused_gru_layer_rev if reverse else jfa.fused_gru_layer
    want_ys, vjp = jax.vjp(jk, jnp.asarray(gi), jnp.asarray(whh),
                           jnp.asarray(bhh))
    want = vjp(jnp.asarray(cot))
    args = [_t(a, grad=True) for a in (gi, whh, bhh)]
    fn = fa.gru_layer_rev if reverse else fa.gru_layer
    ys = fn(*args)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(want_ys),
                               rtol=2e-4, atol=2e-4)
    got = torch.autograd.grad(ys, args, _t(cot))
    for name, a, b in zip(("dgi", "dwhh", "dbhh"), want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_gru_saved_state_and_backward_scan_match_jax(reverse):
    """The plain versions one by one against the JAX VJP's own halves:
    the saved (h_prev, r, z, n, h_n) of ``_fused_gru_layer_fwd`` and the
    (dgi, dWhh, dbhh) of ``_fused_gru_layer_bwd``. JAX's reverse direction
    runs them on flipped arrays; the port reads the rows in place."""
    gi, whh, bhh, cot = _gru_case(3 + reverse)
    flip = (lambda a: a[::-1]) if reverse else (lambda a: a)
    _, res = jfa._fused_gru_layer_fwd(jnp.asarray(flip(gi)),
                                      jnp.asarray(whh), jnp.asarray(bhh))
    dgi_want, dwhh_want, dbhh_want = jfa._fused_gru_layer_bwd(
        res, jnp.asarray(flip(cot)))
    _, saved = fa.gru_layer_save_plain(_t(gi), _t(whh), _t(bhh), reverse)
    for i, name in enumerate(("h_prev", "r", "z", "n", "h_n")):
        np.testing.assert_allclose(saved[i].numpy(),
                                   flip(np.asarray(res[3 + i])),
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    dgi, dgh = fa.gru_layer_bwd_plain(_t(cot), saved, _t(whh), reverse)
    np.testing.assert_allclose(dgi.numpy(), flip(np.asarray(dgi_want)),
                               rtol=2e-4, atol=2e-4)
    # dgh's third block is dn·r where dgi's is dn.
    H = whh.shape[0]
    r = saved[1].numpy()
    np.testing.assert_allclose(dgh[..., 2 * H:].numpy(),
                               dgi[..., 2 * H:].numpy() * r, rtol=1e-6)
    np.testing.assert_allclose(dgh.sum((0, 1)).numpy(),
                               np.asarray(dbhh_want), rtol=2e-4, atol=2e-4)
    dwhh = saved[0].reshape(-1, H).t() @ dgh.reshape(-1, 3 * H)
    np.testing.assert_allclose(dwhh.numpy(), np.asarray(dwhh_want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_gru_training_pair_matches_jax_kernels_bf16(reverse):
    """bf16 projections and gradients through both sides' kernel pair.
    Measured 1.5e-7 of each gradient's largest magnitude: the same casts
    (bf16 dgh and Whhᵀ into the carry product, f32 sums). Bound: a few
    bf16 ulps of a rounding that lands the other way."""
    gi, whh, bhh, cot = _gru_case(5 + reverse, steps=9)
    jk = jfa.fused_gru_layer_rev if reverse else jfa.fused_gru_layer
    want = jax.grad(
        lambda a, w, b: jnp.sum(jk(a.astype(jnp.bfloat16), w, b)
                                .astype(jnp.float32) * cot),
        argnums=(0, 1, 2))(jnp.asarray(gi), jnp.asarray(whh),
                           jnp.asarray(bhh))
    args = [_t(a, grad=True) for a in (gi, whh, bhh)]
    fn = fa.gru_layer_rev if reverse else fa.gru_layer
    ys = fn(args[0].to(torch.bfloat16), args[1], args[2])
    assert ys.dtype == torch.bfloat16
    got = torch.autograd.grad(ys.float(), args, _t(cot))
    for a, b in zip(want, got):
        assert _grad_err(a, b.numpy()) < 0.01


def _bigru_case(dtype, seed=9, H=32, cin=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, cin)).astype(np.float32)
    jm = JaxBiGRU(hidden_dim=H, num_layers=2, dtype=dtype)
    params = numpy_params(init_shapes(jm, x), seed)
    cot = rng.normal(size=(B, 2 * H)).astype(np.float32)
    sd: dict = {}
    convert._gru(params, "g", sd)
    model = BiGRU(cin, H, num_layers=2)
    model.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return jm, params, x, cot, model


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_bigru_gradients_match_jax(bf16):
    """The decoder's BiGRU with the mid-frame trim (scans of 16, 9 and 8
    steps). f32: 1e-4 of each gradient's largest magnitude (JAX's stacked
    XLA scan vs the port's plain loop; measured 7.1e-7). bf16: both sides
    run their GRU kernel pair; measured 0.019 on the input-projection
    biases (sums over the T·B rows of bf16 gradients, which each side
    rounds at other points; the weights 0.005 or less), bound 0.04."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    jm, params, x, cot, model = _bigru_case(jdt)

    def jloss(p, xx):
        out = jm.apply({"params": p}, xx, mid_index=T // 2)
        return jnp.sum(out.astype(jnp.float32) * cot)

    want = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    xt = _t(x, grad=True)
    out = model(xt, mid_index=T // 2, dt=tdt)
    (out.float() * _t(cot)).sum().backward()
    bound = 0.04 if bf16 else 1e-4
    assert _grad_err(want[1], xt.grad.numpy()) < bound
    sd: dict = {}
    convert._gru(jax.device_get(want[0]), "g", sd)
    for name, p in model.named_parameters():
        assert _grad_err(sd[f"g.{name}"].numpy(), p.grad.numpy()) < bound, \
            name


# ----------------------------------------------------------------- losses
@pytest.fixture(scope="module")
def body():
    art = synthetic_artifacts(seed=0, num_verts=V, num_faces=1200)
    rng = np.random.default_rng(0)
    jr = rng.random((J, V)).astype(np.float32)
    jr /= jr.sum(1, keepdims=True)
    return art, jr


def _meshes(seed, n=2):
    """A prediction and a ground truth near it. Not a scaled copy, as in
    tests/test_losses.py: there every predicted edge lies in its ground-truth
    face's plane, |cos| sits at the kink of abs, and the sign of the
    gradient is f32 rounding noise that differs between two frameworks."""
    rng = np.random.default_rng(seed)
    m = (rng.normal(size=(n, V, 3)) * 0.1).astype(np.float32)
    gt = m * 1.15 + 0.01 + rng.normal(size=m.shape) * 0.02
    return m, gt.astype(np.float32)


def test_face_losses_match_plain_and_jax(body):
    art, _ = body
    faces = art.faces
    m, gt = _meshes(1)
    fused = losses.build_face_losses(faces, V, device="cpu")
    faces_t = torch.as_tensor(faces, dtype=torch.long)

    def total(fn, x, g):
        a, b = fn(x, g)
        return 0.1 * a + 20.0 * b

    xt, gtt = _t(m, grad=True), _t(gt, grad=True)
    ln, le = fused(xt, gtt)
    with torch.no_grad():
        np.testing.assert_allclose(
            float(ln), float(losses.normal_loss(xt, gtt, faces_t)),
            rtol=1e-5)
        np.testing.assert_allclose(
            float(le), float(losses.edge_length_loss(xt, gtt, faces_t)),
            rtol=1e-5)
    g_fused, g_gt = torch.autograd.grad(total(fused, xt, gtt), (xt, gtt))
    assert not g_gt.any()     # the ground truth gets a zero gradient
    (g_plain,) = torch.autograd.grad(total(
        lambda x, g: (losses.normal_loss(x, g, faces_t),
                      losses.edge_length_loss(x, g, faces_t)), xt, gtt), xt)
    np.testing.assert_allclose(g_fused.numpy(), g_plain.numpy(),
                               atol=2e-4, rtol=1e-3)

    jfused = jlosses.build_face_losses(faces, V)
    j_ln, j_le = jfused(jnp.asarray(m), jnp.asarray(gt))
    np.testing.assert_allclose(ln.item(), float(j_ln), rtol=1e-5)
    np.testing.assert_allclose(le.item(), float(j_le), rtol=1e-5)
    jg = jax.grad(lambda x: total(jfused, x, jnp.asarray(gt)))(
        jnp.asarray(m))
    np.testing.assert_allclose(g_fused.numpy(), np.asarray(jg), atol=2e-4,
                               rtol=1e-3)


def test_laplacian_loss_matches_jax(body):
    art, _ = body
    m, _ = _meshes(2)
    L = losses.build_laplacian(art.faces, V)
    np.testing.assert_array_equal(L, jlosses.build_laplacian(art.faces, V))
    want = jlosses.laplacian_loss(jnp.asarray(L), jnp.asarray(m))
    got = losses.laplacian_loss(_t(L), _t(m))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _loss_batch(seed, n=B):
    rng = np.random.default_rng(seed)
    m, gt = _meshes(seed, n)

    def mask(*shape):
        return (rng.random(shape) > 0.2).astype(np.float32)

    return {
        "pred_mesh": m,
        "evo_pose": (rng.normal(size=(n, J, 3)) * 0.3).astype(np.float32),
        "pose3d": (rng.normal(size=(n, J, 3)) * 300).astype(np.float32),
        "mesh": gt,
        "lift_pose3d": (rng.normal(size=(n, J, 3)) * 300).astype(np.float32),
        "reg_pose3d": (rng.normal(size=(n, J, 3)) * 300).astype(np.float32),
        "mesh_valid": mask(n, 1, 1), "lift_pose3d_valid": mask(n, J, 1),
        "reg_pose3d_valid": mask(n, J, 1),
    }


@pytest.mark.parametrize("gate", [0.0, 1.0])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_pmce_total_loss_matches_jax_term_by_term(body, gate, fused):
    art, jr = body
    b = _loss_batch(3)
    order = ("pred_mesh", "evo_pose", "pose3d", "mesh", "lift_pose3d",
             "reg_pose3d", "mesh_valid", "lift_pose3d_valid",
             "reg_pose3d_valid")
    want_total, want = jlosses.pmce_total_loss(
        *(jnp.asarray(b[k]) for k in order), jnp.asarray(art.faces),
        jnp.asarray(jr), *WEIGHTS, gate,
        face_loss_fn=jlosses.build_face_losses(art.faces, V) if fused
        else None)
    got_total, got = losses.pmce_total_loss(
        *(_t(b[k]) for k in order), torch.as_tensor(art.faces),
        _t(jr), *WEIGHTS, gate,
        face_loss_fn=losses.build_face_losses(art.faces, V, "cpu") if fused
        else None)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_total), float(want_total),
                               rtol=1e-5)


# ---------------------------------------------------------- whole model
def _pmce_case(seed, dtype=None):
    rng = np.random.default_rng(seed)
    vj = tuple(int(i) for i in rng.integers(0, J, size=NV))
    batch = {k: v for k, v in _loss_batch(seed + 1).items()
             if k not in ("pred_mesh", "evo_pose", "pose3d")}
    batch["pose2d"] = rng.standard_normal((B, T, J, 2), dtype=np.float32)
    batch["img_feature"] = rng.standard_normal((B, T, 2048),
                                               dtype=np.float32)
    batch["_weight"] = np.array([1] * (B - 1) + [0], np.float32)
    jm = JaxPMCE(num_joint=J, vj_relation=vj, **CFG)
    params = numpy_params(init_shapes(jm, batch["pose2d"][:1],
                                      batch["img_feature"][:1]), seed)
    model = PMCE(num_joint=J, vj_relation=vj, dtype=dtype, **CFG)
    model.load_state_dict(convert.state_dict_from_jax(params, vj),
                          strict=True)
    return jm, params, model, batch


def _tensors(batch):
    return {k: _t(v) for k, v in batch.items()}


def test_deterministic_pmce_loss_and_gradients_match_jax_f32(body):
    art, jr = body
    jm, params, model, batch = _pmce_case(21)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jface = jlosses.build_face_losses(art.faces, V)

    def jloss(p):
        mesh, evo, pose3d = jm.apply({"params": p}, jb["pose2d"],
                                     jb["img_feature"], deterministic=True)
        return jlosses.pmce_total_loss(
            mesh, evo, pose3d, jb["mesh"], jb["lift_pose3d"],
            jb["reg_pose3d"], jb["mesh_valid"], jb["lift_pose3d_valid"],
            jb["reg_pose3d_valid"], jnp.asarray(art.faces),
            jnp.asarray(jr), *WEIGHTS, 1.0, face_loss_fn=jface)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, params))
    model.eval()
    loss, terms = pmce_loss(
        model, _tensors(batch), torch.as_tensor(art.faces), _t(jr), WEIGHTS,
        1.0, losses.build_face_losses(art.faces, V, "cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    g_want = convert.state_dict_from_jax(jax.device_get(want_grads))
    largest = max(float(g.abs().max()) for g in g_want.values())
    for name, p in model.named_parameters():
        want = g_want[name].numpy()
        if p.grad is None:
            # Only the last block's joint stream reaches the output (every
            # block re-reads the lifted joints): JAX's gradient is zero.
            assert name.startswith("pose_mesh_coevo.coevoblock"), name
            assert not want.any(), name
        elif np.abs(want).max() < 1e-6 * largest:
            # Zero up to rounding (~1e-9) on both sides: the key biases
            # (``wk.bias`` and the keys' AdaLN β) add one vector to every
            # key, which the softmax ignores. Held to the model's largest
            # gradient instead.
            assert name.endswith(("wk.bias", "normk.mlp_beta.weight",
                                  "normk.mlp_beta.bias")), name
            assert np.abs(p.grad.numpy() - want).max() <= 1e-4 * largest
        else:
            assert _grad_err(want, p.grad.numpy()) <= 1e-4, name


def test_pmce_eval_step_matches_jax(body):
    _, jr = body
    jm, params, model, batch = _pmce_case(22)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax_eval_step(jm, jnp.asarray(jr))(
        jax.tree_util.tree_map(jnp.asarray, params), jb)
    model.train()   # the eval step itself switches to eval mode
    got = make_pmce_eval_step(model, jr)(_tensors(batch))
    assert not model.training
    for k in ("mesh_err_sum", "joint_err_sum"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(got["n"]) == float(want["n"]) == B - 1
    assert rel_max_err(want["pred_mesh"], got["pred_mesh"].numpy()) <= 1e-5


# ------------------------------------------------------------- repairs
def test_bigru_takes_the_gru_kernel_path_under_bf16_unfused():
    """JAX gates its GRU kernel on bf16 alone (``layers.py:734``); so does
    the port, with ``fused=False`` too (on the CPU the wrapper runs the
    plain versions)."""
    _, _, model, batch = _pmce_case(23, dtype=torch.bfloat16)
    calls = []

    def spy(real):
        def fn(*a):
            calls.append(real.__name__)
            return real(*a)
        return fn

    with mock.patch.object(fa, "gru_layer", spy(fa.gru_layer)), \
            mock.patch.object(fa, "gru_layer_rev", spy(fa.gru_layer_rev)):
        model.train()
        mesh, _, _ = model(_t(batch["pose2d"]), _t(batch["img_feature"]),
                           generator=torch.Generator().manual_seed(0))
        mesh.sum().backward()
    assert sorted(calls) == ["gru_layer"] * 2 + ["gru_layer_rev"] * 2
    assert model.pose_mesh_coevo.gru_cur.weight_hh_l0.grad.abs().sum() > 0


def test_fused_decoder_runs_its_chain_in_eval_mode_only():
    """Under ``fused`` the decoder runs its whole-chain kernel in eval mode
    only; in training mode its blocks run one by one through their own
    attention-block wrappers, and the chain is not called."""
    _, _, model, batch = _pmce_case(24)
    model.pose_lifter.fused = model.pose_mesh_coevo.fused = True
    args = (_t(batch["pose2d"]), _t(batch["img_feature"]))
    with mock.patch.object(fc, "coevo_chain",
                           wraps=fc.coevo_chain) as chain, \
            mock.patch.object(fa, "fused_mhsa",
                              wraps=fa.fused_mhsa) as mhsa:
        with torch.no_grad():
            model.eval()(*args)
        assert chain.call_count == 1 and mhsa.call_count == 0
        model.train()
        outs = model(*args, generator=torch.Generator().manual_seed(0))
        assert chain.call_count == 1
        # 17 joints and 40 coarse vertices, both ≤ 64: each block's two
        # self-attentions are fused_mhsa (its cross-attentions modular).
        assert mhsa.call_count == 2 * model.pose_mesh_coevo.num_blocks
    assert all(bool(torch.isfinite(o).all()) for o in outs)


# ------------------------------------------------------------- trainer
@pytest.fixture(scope="module")
def mesh_datasets(body):
    art, jr = body
    seqs = [generate_sequences(art, jr, num_videos=2, frames_per_video=40,
                               seed=s, device="cpu") for s in (0, 1)]
    return tuple(ClipDataset(s, seqlen=T, stride=1, chunk_mode="mesh")
                 for s in seqs)


def _pmce_trainer(body, mesh_datasets, ckpt_dir, seed=0):
    art, jr = body
    cfg = Config()
    cfg.MODEL.name = "PMCE"
    cfg.TRAIN.lr, cfg.TRAIN.lr_step = 1e-3, [1]
    cfg.TRAIN.batch_size = cfg.TEST.batch_size = B
    cfg.TRAIN.end_epoch, cfg.TRAIN.steps_per_epoch = 2, 3
    cfg.TRAIN.edge_loss_start = 1
    model = PMCE(num_joint=J, vj_relation=VJ, **CFG)
    perturbed_init(model, torch.Generator().manual_seed(seed))
    train_ds, test_ds = mesh_datasets
    log = []
    trainer = Trainer(cfg=cfg, model=model,
                      train_data=MultiDataset([train_ds], seed=0),
                      test_data=test_ds, faces=art.faces, J_reg_target=jr,
                      ckpt_dir=ckpt_dir, device="cpu", log_fn=log.append)
    return trainer, log


def test_pmce_trainer_fit_edge_gate_restore(body, mesh_datasets, tmp_path):
    trainer, log = _pmce_trainer(body, mesh_datasets, str(tmp_path))
    gates = []
    step = trainer.train_step

    def recording_step(state, batch, gen, edge_gate):
        gates.append(edge_gate)
        loss, terms = step(state, batch, gen, edge_gate)
        assert set(terms) == {"vertex", "normal", "edge", "reg_joint",
                              "evo_joint", "lift_joint"}
        return loss, terms

    trainer.train_step = recording_step
    state = trainer.fit()
    # TRAIN.edge_loss_start = 1: epoch 1 trains without the edge term,
    # epoch 2 with it.
    assert gates == [0.0] * 3 + [1.0] * 3
    assert state.step == 6
    assert all(np.isfinite(trainer.loss_history))
    for k in ("joint", "surface"):
        assert len(trainer.error_history[k]) == 2
        assert all(np.isfinite(trainer.error_history[k]))
        assert all(e > 0 for e in trainer.error_history[k])
    assert any("MPVPE" in s for s in log)
    assert sorted(os.listdir(tmp_path)) == ["best.ckpt", "checkpoint1.ckpt",
                                            "final.ckpt"]

    fresh, _ = _pmce_trainer(body, mesh_datasets, "", seed=5)
    restored, epoch = fresh.restore(str(tmp_path))
    assert epoch == 2 and restored.step == 6
    assert fresh.error_history == trainer.error_history
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            fresh.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_lifter_warm_start_loads_stage1_weights(tmp_path):
    lifter = create_pose_lifter(num_joints=J, embed_dim=32, depth=1,
                                device="cpu", seed=3)
    ckpt_lib.save_checkpoint(str(tmp_path), 1, 1,
                             {"params": lifter.state_dict()}, is_best=True)
    model = PMCE(num_joint=J, vj_relation=VJ, **CFG)
    perturbed_init(model, torch.Generator().manual_seed(0))
    decoder = {k: v.clone() for k, v in
               model.pose_mesh_coevo.state_dict().items()}
    load_lifter_checkpoint(model, str(tmp_path))
    for (name, a), b in zip(lifter.state_dict().items(),
                            model.pose_lifter.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)
    for name, v in model.pose_mesh_coevo.state_dict().items():
        assert torch.equal(v, decoder[name]), name
    deeper = create_pose_lifter(num_joints=J, embed_dim=32, depth=2,
                                device="cpu")
    ckpt_lib.save_checkpoint(str(tmp_path / "d2"), 1, 1,
                             {"params": deeper.state_dict()})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_lifter_checkpoint(model, str(tmp_path / "d2"))
