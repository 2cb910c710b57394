"""`fleet_merge` (a loop of `apply_op_batch` over a sequence of batches
that sums the valid-lane counts) in the torch port against the JAX
reference: the same numpy-seeded rounds through both, exact int32
equality on the real key columns and an equal total (tolerance: none)."""

import numpy as np
import pytest
import torch

from automerge_tpu.fleet import fleet_merge as jax_fleet_merge
from automerge_tpu.fleet.tensor_doc import FleetState as JaxState
from automerge_tpu_torch.fleet import fleet_merge
from automerge_tpu_torch.fleet import merge_kernel
from automerge_tpu_torch.fleet.tensor_doc import FleetState

from tests.test_torch_merge import (assert_match, both_ops, random_cols,
                                    seeded_states)

torch.set_num_threads(1)   # small tensors: the intra-op pool costs more


@pytest.mark.parametrize('n_docs,n_keys,p,rounds', [
    (8, 17, 12, 3), (16, 40, 33, 2), (4, 9, 1, 4)])
def test_fleet_merge_matches_reference(n_docs, n_keys, p, rounds):
    rng = np.random.default_rng(n_docs * 1000 + p)
    jstate, tstate = seeded_states(rng, n_docs, n_keys)
    batches = [both_ops(random_cols(rng, n_docs, n_keys, p,
                                    ctr0=100 + 50 * r))
               for r in range(rounds)]
    before = [t.clone() for t in tstate.tensors()]
    jout, jtotal = jax_fleet_merge(jstate, [j for j, _ in batches])
    tout, ttotal = fleet_merge(tstate, [t for _, t in batches])
    assert_match(jout, tout, n_keys)
    assert ttotal == jtotal
    assert isinstance(ttotal, int)
    # like apply_op_batch, the input state is left intact
    for was, now in zip(before, tstate.tensors()):
        assert torch.equal(was, now)


def test_fleet_merge_of_no_batches_is_the_input():
    jout, jtotal = jax_fleet_merge(JaxState.empty(4, 8), [])
    state = FleetState.empty(4, 8, 'cpu')
    launches = merge_kernel.LAUNCHES['lww_merge']
    tout, ttotal = fleet_merge(state, [])
    assert tout is state and ttotal == jtotal == 0
    assert_match(jout, tout, 8)
    assert merge_kernel.LAUNCHES['lww_merge'] == launches
