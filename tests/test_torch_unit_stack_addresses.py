"""convert.stack_addresses: the batch layout of read_batch and rmw_batch
for prepared and for coefficient-domain addresses, and what it refuses.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import pytest
import torch

from fhe_ram_tpu_torch.convert import stack_addresses
from fhe_ram_tpu_torch.ram.address import Address, AddressPrepared


def test_stack_addresses_stacks_either_kind_and_refuses_a_mix():
    def coords(lead, fill):
        return tuple(torch.full(lead + (dig, 2, 2, 2, 3, 8), fill, dtype=torch.int32)
                     for dig in (1, 2))
    plain = [Address(coords((), k)) for k in range(3)]
    prepared = [AddressPrepared(coords((3,), 10 + k)) for k in range(3)]
    for addrs, lead in ((plain, ()), (prepared, (3,))):
        stacked = stack_addresses(addrs)
        assert isinstance(stacked, tuple) and len(stacked) == 2
        for i, s in enumerate(stacked):
            assert s.dtype == torch.int32
            assert s.shape == (3,) + lead + (i + 1, 2, 2, 2, 3, 8)
            for k in range(3):   # address k is item k of every coordinate
                assert torch.equal(s[k], addrs[k].coordinates[i])
    assert stack_addresses(iter(plain[:1]))[0].shape[0] == 1
    with pytest.raises(ValueError):
        stack_addresses([])
    with pytest.raises(ValueError):
        stack_addresses([plain[0], prepared[0]])
