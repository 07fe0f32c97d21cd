"""One instant test (see ROADMAP.md, "Time budget"): the strided row layout
of parallel/mesh.py -- shard k holds the global rows congruent to k, and
unshard_rows inverts shard_data_rows."""

import numpy as np
import torch

from fhe_ram_tpu_torch.parallel import mesh


def test_strided_row_layout_and_its_inverse():
    perm = mesh.row_shard_perm(8, 4)
    assert perm.tolist() == [0, 4, 1, 5, 2, 6, 3, 7]
    assert np.array_equal(np.argsort(perm)[perm], np.arange(8))
    data = torch.arange(2 * 8 * 3, dtype=torch.int32).reshape(2, 8, 3)
    m = mesh.make_mesh(4, rows=4, devices=["cpu"] * 4)
    shards = mesh.shard_data_rows(m, data)
    assert [s.shape for s in shards] == [(2, 2, 3)] * 4
    assert torch.equal(shards[1], data[:, [1, 5]])
    assert torch.equal(mesh.unshard_rows(shards), data)
