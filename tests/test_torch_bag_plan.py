"""The embedding bag's work split (``embedding_bag.bag_plan``), on the CPU.

The kernel takes its plan from the shapes and the table's address alone.
Here, over a grid of (B, L, D, itemsize, alignment): the load width divides
the row and the address, a warp's lane groups fit in it, a bag gets no more
warps than its ids can keep busy, a small batch still fills the card, and
the plan reads no data. ``_emulate`` follows the kernel's order of adds
(warp slices, compacted ids, lane groups, the fold tree, warps in order):
on integer-valued rows every order is exact, so it equals the plain version
only if each valid row is added exactly once. The kernel itself is held
against the plain version on the card by ``tests/test_torch_cuda.py``.
"""
import itertools
import math

import pytest
import torch

from repro_torch.kernels import embedding_bag as eb

H100_SMS = 132
GRID = list(itertools.product(
    [1, 37, 512, 4096, 65536],          # B
    [1, 10, 45, 100, 1000],             # L
    [1, 10, 18, 40, 64, 129, 4096],     # D
    [4, 2],                             # itemsize
    [16, 8, 4, 2]))                     # alignment of the table's base


def _rows_per_pass(plan):
    return 32 // plan.lanes


def test_width_divides_the_row_and_the_address():
    for b, l, d, item, align in GRID:
        if align < item:
            continue
        plan = eb.bag_plan(b, l, d, item, align)
        assert plan.width in (16, 8, 4, 2) and plan.width >= item
        assert (d * item) % plan.width == 0 and align % plan.width == 0
        wider = 2 * plan.width
        assert wider > 16 or (d * item) % wider or align % wider
        assert plan.lanes == min(d * item // plan.width, 32)


def test_lane_groups_fit_in_a_warp():
    for b, l, d, item, align in GRID:
        plan = eb.bag_plan(b, l, d, item, max(align, item))
        assert 1 <= plan.lanes * _rows_per_pass(plan) <= 32


def test_warps_per_bag_follow_the_ids_and_the_block():
    for b, l, d, item, align in GRID:
        plan = eb.bag_plan(b, l, d, item, max(align, item))
        w = plan.warps_per_bag
        assert w in (1, 2, 4, 8)
        assert w <= max(1, math.ceil(l / eb.BAG_MIN_IDS))
        # a bag is split only while the launch is short of warps
        assert w == 1 or b * w // 2 < eb.BAG_WARPS
    assert eb.bag_plan(65536, 100, 18, 4, 16).warps_per_bag == 1


@pytest.mark.parametrize("d,item", [(18, 4), (10, 4), (64, 2), (129, 4)])
def test_a_small_batch_fills_the_card(d, item):
    """DIN serve_p99: B = 512 bags of L = 100 ids are 512 blocks (one a
    bag), at least one for each of the H100's 132 SMs, of four warps each:
    2,048 warps, where one warp a bag would give 512."""
    plan = eb.bag_plan(512, 100, d, item, 16)
    assert 512 >= H100_SMS and plan.warps_per_bag == 4


def test_plan_depends_on_the_shapes_alone():
    g = torch.Generator().manual_seed(0)
    flat = torch.randn(5000 * 18 + 4, generator=g)
    a = flat[:90000].view(5000, 18)
    b = torch.randn(5000, 18, generator=g)
    ids = [torch.randint(-1, 5000, (512, 100), generator=g,
                         dtype=torch.int32) for _ in range(2)]
    plans = {eb.table_plan(t, i) for t in (a, b) for i in ids}
    assert plans == {eb.bag_plan(512, 100, 18, 4, 16)}
    # DIN's rows: 8-byte loads, 9 lanes a row, 3 rows a pass
    assert eb.bag_plan(512, 100, 18, 4, 16)[:2] == (8, 9)
    # a view one element in narrows the loads to one element
    assert eb.table_plan(flat[1:90001].view(5000, 18), ids[0]).width == 4
    assert eb.table_plan(flat.half()[1:90001].view(5000, 18),
                         ids[0]).width == 2


def test_shapes_past_32_bits_raise():
    with pytest.raises(ValueError, match="no plan"):
        eb.bag_plan(2**31, 10, 18, 4, 16)
    with pytest.raises(ValueError, match="no plan"):
        eb.bag_plan(8, 10, 2**30, 4, 16)


def _emulate(table, idx, plan, mean):
    """The kernel's order of f32 adds, per bag, under ``plan``."""
    b, l = idx.shape
    w_n, lanes = plan.warps_per_bag, plan.lanes
    r = 32 // lanes
    s = -(-l // w_n)
    out = torch.zeros(b, table.shape[1])
    for bag in range(b):
        warps = []
        for w in range(w_n):
            ids = idx[bag, min(w * s, l): min(w * s + s, l)]
            valid = ids[ids >= 0]
            groups = [torch.zeros(table.shape[1]) for _ in range(r)]
            for k, i in enumerate(valid.tolist()):
                groups[k % r] = groups[k % r] + table[i]
            step = 1 << (r - 1).bit_length() >> 1 if r > 1 else 0
            while step:
                for gi in range(min(step, r - step)):
                    groups[gi] = groups[gi] + groups[gi + step]
                step >>= 1
            warps.append(groups[0])
        acc = warps[0]
        for part in warps[1:]:
            acc = acc + part
        out[bag] = acc / max(int((idx[bag] >= 0).sum()), 1) if mean else acc
    return out


@pytest.mark.parametrize("b,l,d", [(3, 100, 18), (5, 45, 1), (2, 300, 10),
                                   (600, 3, 40)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_every_valid_row_is_added_once(b, l, d, mode):
    g = torch.Generator().manual_seed(b + l + d)
    table = torch.randint(-8, 9, (50, d), generator=g).float()
    idx = torch.randint(-1, 50, (b, l), generator=g, dtype=torch.int32)
    idx[0] = -1
    plan = eb.table_plan(table, idx)
    got = _emulate(table, idx, plan, mode == "mean")
    assert torch.equal(got, eb.embedding_bag_plain(table, idx, mode=mode))
