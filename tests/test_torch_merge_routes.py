"""The launch plan of the CUDA merge (merge_kernel._launch_plan), which
picks one of the kernel's three routes (warp, cta, fresh;
automerge_tpu_torch/fleet/csrc/lww_merge.cu) and the fresh route's
shared-memory tiles, and what `_launch` refuses before it reaches the
card. The function every route computes is held against the JAX
reference at the routes' corner shapes by tests/test_torch_merge.py,
and the kernel against its plain version on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from automerge_tpu_torch.fleet import merge_kernel
from automerge_tpu_torch.fleet.merge_cases import random_cols
from automerge_tpu_torch.fleet.tensor_doc import FleetState, OpBatch

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)


CPU = torch.device('cpu')

# ---- the launch plan --------------------------------------------------------

@pytest.mark.parametrize('p,route', [(0, 'warp'), (1, 'warp'), (20, 'warp'),
                                     (32, 'warp'), (33, 'cta'),
                                     (1500, 'cta')])
def test_plan_route_by_lanes(p, route):
    plan = merge_kernel._launch_plan(10_000, p, 1025, fresh=False)
    assert plan.route == route
    assert plan.smem_cells == 0
    if route == 'warp':
        assert plan.threads == 32 * plan.docs_per_cta <= 256
        assert plan.grid * plan.docs_per_cta >= 10_000
        assert (plan.grid - 1) * plan.docs_per_cta < 10_000
    else:
        assert plan.grid == 10_000
    fresh = merge_kernel._launch_plan(10_000, p, 1025, fresh=True)
    assert fresh.route == 'fresh'


# the widest row a fresh tile holds whole (the key chunk of wider rows)
ROOM = merge_kernel._launch_plan(1, 0, 10**6, fresh=True).key_chunk


@pytest.mark.parametrize('n,k1', [(10_000, 1025), (7, 1025), (1, 1),
                                  (5, ROOM), (5, ROOM + 1), (3, 20_001),
                                  (2, 100_003)])
def test_fresh_plan_tiles_cover_every_cell_once(n, k1):
    plan = merge_kernel._launch_plan(n, 20, k1, fresh=True)
    assert 3 * plan.smem_cells * 4 <= merge_kernel.FRESH_SMEM_BUDGET
    assert plan.smem_cells % 4 == 0
    assert plan.threads % 32 == 0 and plan.threads <= 256
    assert plan.docs_per_cta == 1 or plan.key_chunk == k1
    hits = np.zeros(n * k1, np.int32)
    for b in range(plan.grid):
        d0, d1, c0, c1 = merge_kernel._fresh_tile(plan, n, k1, b)
        assert d0 < d1 and c0 < c1
        f0, f1 = d0 * k1 + c0, (d1 - 1) * k1 + c1
        # one flat range, with room for 3 cells of alignment slack
        assert f1 - f0 == (d1 - d0) * (c1 - c0)
        assert f1 - f0 + 3 <= plan.smem_cells
        hits[f0:f1] += 1
    assert (hits == 1).all()


def test_fresh_plan_keeps_several_ctas_per_sm():
    """At the seam's width a tile holds whole rows, and at least two
    tiles fit one H100 SM's 228 KB of shared memory (1 KB reserved per
    CTA), for every row width."""
    plan = merge_kernel._launch_plan(10_000, 20, 1025, fresh=True)
    assert plan.key_chunk == 1025 and plan.docs_per_cta >= 2
    for k1 in (1025, 50_000):
        plan = merge_kernel._launch_plan(10_000, 20, k1, fresh=True)
        assert 2 * (3 * plan.smem_cells * 4 + 1024) <= 228 * 1024


def test_launch_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(3)
    state = FleetState.empty(4, 9, CPU)
    ops = OpBatch(*random_cols(rng, 4, 9, 33)).to(CPU)
    stats = torch.zeros(1, dtype=torch.int32)
    warp = merge_kernel._launch_plan(4, 32, 10, fresh=False)
    with pytest.raises(ValueError, match='does not fit'):
        merge_kernel._launch(state, ops, warp, False, stats)
    cta = merge_kernel._launch_plan(4, 33, 10, fresh=False)
    with pytest.raises(ValueError, match='CUDA tensors only'):
        merge_kernel._launch(state, ops, cta, False, stats)
    assert int(stats) == 0
