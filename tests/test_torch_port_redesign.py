"""The host side of the redesigned trunk (K1) and block program (K3), on
the CPU: the trunk's route by group size, the wrapper reaching each route
on the card (the launches stubbed), the coevo kernels' pointer table with
its products transposed, and the stage-stamp bookkeeping that
``chip_smoke.py --profile`` prints. The kernels themselves are held
against their plain versions by ``tests/test_torch_port_gpu.py`` on the
card."""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

from pmce_tpu_torch.ops import fused_attention as fa
from pmce_tpu_torch.ops import fused_coevo_chain as fc


@pytest.mark.parametrize("T,J,route", [
    (16, 19, "block"), (16, 17, "block"), (48, 17, "block"),
    (81, 17, "block"), (4, 40, "block"), (128, 1, "block"),
    (1, 128, "block"), (129, 2, "long"), (4, 129, "long"),
    (243, 17, "long")])
def test_trunk_route_by_group_size(T, J, route):
    """Groups of up to a tile's 128 rows (J joints of a frame, T frames of
    a joint) take the one-launch-per-block kernel; longer ones the long
    route."""
    assert fa.TRUNK_TILE_ROWS == 128
    assert fa.trunk_route(T, J) == route


def _trunk_args(T, J, depth=1, C=256, hid=512, B=1):
    rng = np.random.default_rng(T * 100 + J)

    def r(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.1)

    params = tuple((r(C), r(C), r(C, 3 * C), r(3 * C), r(C, C), r(C), r(C),
                    r(C), r(C, hid), r(hid), r(hid, C), r(C))
                   for _ in range(2 * depth))
    return (r(B, T * J, C).to(torch.bfloat16), params, (r(C), r(C)),
            (r(C), r(C)), r(T, C), T, J, depth, 8)


@pytest.mark.parametrize("T,J,route", [(16, 19, "block"), (130, 2, "long"),
                                       (2, 130, "long")])
def test_trunk_wrapper_reaches_its_route_on_the_card(T, J, route):
    """With the device test answering "card" and both routes stubbed, the
    wrapper calls exactly the route :func:`trunk_route` names, never the
    plain version."""
    block = mock.Mock(side_effect=RuntimeError("block route"))
    long = mock.Mock(side_effect=RuntimeError("long route"))
    with mock.patch.object(fa, "_on_card", return_value=True), \
            mock.patch.object(fa, "_lifter_trunk_cuda", block), \
            mock.patch.object(fa, "_lifter_trunk_long", long), \
            mock.patch.object(fa, "lifter_trunk_plain",
                              side_effect=AssertionError("plain ran")), \
            torch.no_grad(), \
            pytest.raises(RuntimeError, match=f"{route} route"):
        fa.lifter_trunk(*_trunk_args(T, J))
    assert (block.call_count, long.call_count) == (
        (1, 0) if route == "block" else (0, 1))


def test_coevo_table_stores_products_transposed():
    """The block table holds every product as W^T [N, K] in bf16 (the B
    fragments' layout of csrc/coevo_ops.cuh) and every vector in f32; the
    chain's 3 -> C embeds stay [3, C]."""
    rng = np.random.default_rng(0)
    J, V, C, hid = 19, 48, 64, 256

    def t(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))

    def ca():
        return (t(C, C), t(C), t(C, C), t(C), t(C, C), t(C), t(C, C), t(C),
                t(C, hid), t(hid), t(hid, C), t(C))

    def sa():
        return (t(C, 3 * C), t(3 * C), t(C, C), t(C), t(C, hid), t(hid),
                t(hid, C), t(C))

    kp = (t(J, C), t(V, C), t(J, C), t(V, C), t(V, C), t(J, C), t(C, C),
          t(C), t(C, C), t(C), ca(), ca(), sa(), sa())
    tab = fc._Table(torch.device("cpu"), C, hid)
    wjp = t(3, C).to(torch.bfloat16)
    tab.embed(wjp, t(C), C)
    tab.block(kp, J, V)
    assert len(tab.keep) == 2 + fc._BLOCK_TABLE_LEN
    assert torch.equal(tab.keep[0], wjp)
    blk = tab.keep[2:]
    # wv2j [C, C] and the SA qkv [C, 3C], the MLP's w1 [C, hid] and
    # w2 [hid, C], transposed.
    assert torch.equal(blk[6], kp[6].t().to(torch.bfloat16))
    sa_j = blk[34:42]
    assert sa_j[0].shape == (3 * C, C) and sa_j[0].dtype == torch.bfloat16
    assert torch.equal(sa_j[0], kp[12][0].t().to(torch.bfloat16))
    assert sa_j[4].shape == (hid, C) and sa_j[6].shape == (C, hid)
    assert all(v.dtype == torch.float32 for v in blk[:6] + [blk[7]])


def test_stamp_split_books_each_interval_to_its_end_code():
    """Each interval between two stamps counts toward the (stage, kind)
    code stamped at its end, summed over the clips; unused slots (clock 0)
    are ignored."""
    n = 8
    stamps = torch.zeros(2, n, 2, dtype=torch.int64)
    # clip 0: start, stage 1 gemm (+10), vertex SA attention (+5), vertex SA
    # fc2 (+7); clip 1: start, vertex SA attention (+3).
    for row, seq in ((0, [(0, 100), (1 * 8 + 1, 110), (5 * 8 + 3, 115),
                          (5 * 8 + 5, 122)]),
                     (1, [(0, 50), (5 * 8 + 3, 53)])):
        for i, (code, clock) in enumerate(seq):
            stamps[row, i] = torch.tensor([code, clock])
    split = fc.stamp_split(stamps)
    assert split == {("stage 1", "gemm"): 10,
                     ("vertex SA", "attention"): 8,
                     ("vertex SA", "mlp fc2"): 7}


def test_stamp_names_cover_the_kernel_codes():
    """Six stages and six kinds, as csrc/coevo_ops.cuh codes them; the
    trunk's eight stages in its kernel's order."""
    assert len(fc.STAMP_STAGES) == 6 and len(fc.STAMP_KINDS) == 6
    assert fa.TRUNK_STAGES == ("LN1", "QKV", "attention", "proj", "LN2",
                               "fc1", "fc2", "post-norm + store")
