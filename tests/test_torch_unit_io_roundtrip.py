"""utils/io.py on the port alone: an address of three coordinates and a
pending RAM state come back as they were saved, in order, on the device
asked for; the Params are checked only when given.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import dataclasses

import numpy as np
import pytest
import torch

from fhe_ram_tpu_torch.params import PARAMS_TEST_3LVL as PAR
from fhe_ram_tpu_torch.ram.address import Address
from fhe_ram_tpu_torch.utils import io


def test_address_and_pending_state_round_trip(tmp_path):
    rnd = np.random.default_rng(10)

    def limbs(*shape):
        return torch.from_numpy(
            rnd.integers(-(1 << 16), 1 << 16, size=shape).astype(np.int32))

    addr = Address(tuple(limbs(dig, 2, 2, 2, 3, 8) for dig in (1, 2, 3)))
    path = str(tmp_path / "addr.npz")
    io.save_address(path, PAR, addr)
    back = io.load_address(path, PAR, device="cpu")
    assert len(back.coordinates) == 3
    for a, b in zip(back.coordinates, addr.coordinates):
        assert a.dtype == torch.int32 and a.device.type == "cpu" and torch.equal(a, b)

    data, tree = limbs(2, 4, 2, 3, 8), (limbs(2, 2, 2, 3, 8), limbs(2, 1, 2, 3, 8))
    path = str(tmp_path / "ram.npz")
    io.save_ram_state(path, PAR, data, tree)
    got_data, got_tree = io.load_ram_state(path, device="cpu")   # unchecked
    assert torch.equal(got_data, data) and len(got_tree) == 2
    assert all(torch.equal(a, b) for a, b in zip(got_tree, tree))
    io.save_ram_state(path, PAR, data)
    assert io.load_ram_state(path, PAR, device="cpu")[1] == ()
    with pytest.raises(ValueError):
        io.load_ram_state(path, dataclasses.replace(PAR, k_pt=PAR.k_pt + 1),
                          device="cpu")
