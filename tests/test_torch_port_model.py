"""The whole port against the JAX PMCE, at reduced width on the CPU.

Embed 64, depth 3, GRU 128, joint/vertex width 64 (the chain needs them
equal), 31 coarse and 97 full vertices, J = 17 and 19, batch 8 — every seam
of the full model (lifter, ÷1000, BiGRU with the mid-frame trim, vertex
gather, three CoevoBlocks, upsample GEMM, residual heads). Weights come
from numpy with a seed and reach the port through ``convert.py``.

- f32: JAX ``fused_attn=False`` (plain XLA) vs the port, modular and
  ``fused=True`` (the plain versions of the kernels on the CPU): 1e-4, the
  bound of tests/test_whole_model_parity.py.
- bf16: JAX ``fused_attn=True`` (all three Pallas kernels, interpreted) vs
  the port's ``fused=True``: a bf16 band relative to each output's largest
  magnitude, pinned at ≈2× the measured value.
- f32 at full width (embed 256, GRU 1024, 431 → 6890 vertices), J = 19,
  batch 2: the same 1e-4 bound (about 15 s on a CPU).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmce_tpu.models.pmce import PMCE as JaxPMCE
from pmce_tpu.models.pmce import resolve_compute_dtype as jax_policy
from pmce_tpu_torch.convert import state_dict_from_jax
from pmce_tpu_torch.models.pmce import PMCE, resolve_compute_dtype

from torch_port_common import init_shapes, numpy_params, rel_max_err

T, B = 16, 8
CFG = dict(embed_dim=64, depth=3, num_vertx=31, num_verts_full=97,
           joint_dim=64, vertx_dim=64, gru_hidden=128, seqlen=T)
FULL_CFG = dict(CFG, embed_dim=256, num_vertx=431, num_verts_full=6890,
                gru_hidden=1024)
NAMES = ("mesh", "evo_pose", "pose3d")
# Measured max|port - jax| / max|jax| per output (J=17, J=19), bf16:
#   mesh 0.0046 / 0.0038, evo_pose 0.0034 / 0.0040, pose3d 0.0100 / 0.0101.
# The Pallas kernels' tanh-GELU and clamped unshifted softmax vs the port's
# erf-GELU and max-stabilised softmax, amplified through 6 trunk blocks and
# 3 CoevoBlocks; pose3d (mm, through the f32 head) carries the most. For
# scale: each bf16 path is as far from the f32 model (JAX bf16 vs f32:
# 0.006 / 0.005 / 0.012 at J=17; the port's: 0.006 / 0.005 / 0.011).
BF16_BOUND = {"mesh": 0.01, "evo_pose": 0.008, "pose3d": 0.02}


def _case(J, seed, cfg=CFG, batch=B):
    rng = np.random.default_rng(seed)
    vj = tuple(int(i) for i in rng.integers(0, J, size=cfg["num_vertx"]))
    pose2d = rng.standard_normal((batch, T, J, 2), dtype=np.float32)
    feat = rng.standard_normal((batch, T, 2048), dtype=np.float32)
    jm = JaxPMCE(num_joint=J, vj_relation=vj, **cfg)
    params = numpy_params(init_shapes(jm, pose2d[:1], feat[:1]), seed)
    return vj, params, pose2d, feat


def _jax_outputs(J, vj, params, pose2d, feat, cfg=CFG, **policy):
    jm = JaxPMCE(num_joint=J, vj_relation=vj, **cfg, **policy)
    out = jax.jit(jm.apply)({"params": params}, jnp.asarray(pose2d),
                            jnp.asarray(feat))
    return [np.asarray(o, np.float32) for o in out]


def _port_outputs(J, vj, params, pose2d, feat, cfg=CFG, **policy):
    pm = PMCE(num_joint=J, vj_relation=vj, **cfg, **policy).eval()
    pm.load_state_dict(state_dict_from_jax(params, vj), strict=True)
    with torch.no_grad():
        out = pm(torch.from_numpy(pose2d), torch.from_numpy(feat))
    for o in out:
        assert o.dtype == torch.float32
    return [o.numpy() for o in out]


@pytest.fixture(scope="module", params=[17, 19], ids=["h36m17", "coco19"])
def case(request):
    J = request.param
    return (J,) + _case(J, seed=J)


def _assert_f32_matches_jax(J, vj, params, pose2d, feat, cfg=CFG):
    want = _jax_outputs(J, vj, params, pose2d, feat, cfg, fused_attn=False)
    for fused in (False, True):
        got = _port_outputs(J, vj, params, pose2d, feat, cfg, fused=fused)
        for name, a, b in zip(NAMES, got, want):
            assert a.shape == b.shape, name
            assert np.abs(b).mean() > 1e-3, f"{name}: degenerate output"
            np.testing.assert_allclose(
                a, b, rtol=1e-4, atol=1e-4,
                err_msg=f"{name} (port fused={fused}) diverges from JAX")


def test_f32_matches_jax(case):
    _assert_f32_matches_jax(*case)


def test_f32_full_size_matches_jax():
    J = 19
    _assert_f32_matches_jax(J, *_case(J, seed=7, cfg=FULL_CFG, batch=2),
                            cfg=FULL_CFG)


def test_bf16_kernel_path_matches_jax_kernels(case):
    J, vj, params, pose2d, feat = case
    want = _jax_outputs(J, vj, params, pose2d, feat, dtype=jnp.bfloat16,
                        fused_attn=True)
    got = _port_outputs(J, vj, params, pose2d, feat, dtype=torch.bfloat16,
                        fused=True)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        assert np.isfinite(a).all(), name
        err = rel_max_err(b, a)
        assert err < BF16_BOUND[name], f"{name}: {err}"


@pytest.mark.parametrize("name", ["float32", "f32", "bfloat16", "bf16"])
def test_compute_dtype_policy_matches_jax(name):
    want, got = jax_policy(name), resolve_compute_dtype(name)
    assert (got is None) == (want is None)
    if got is not None:
        assert str(got).split(".")[-1] == jnp.dtype(want).name


def test_compute_dtype_policy_rejects_unknown_names():
    with pytest.raises(ValueError, match="float16"):
        resolve_compute_dtype("float16")
