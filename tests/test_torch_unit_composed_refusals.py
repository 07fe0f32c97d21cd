"""What the composed configuration (a two-pass context, FheRam(composed=
True)) refuses: the one-launch trees, which have no two-pass body, and the
VM, whose composed routes are not ported yet.
One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import pytest
import torch

from fhe_ram_tpu_torch.params import PARAMS_TEST_SMALL_WIDE as TWIDE
from fhe_ram_tpu_torch.ops.ntt import fused_path_active, get_ntt_context
from fhe_ram_tpu_torch.core import keys as tkeys
from fhe_ram_tpu_torch.core import keyswitch, packer
from fhe_ram_tpu_torch.ram import ram as tram
from fhe_ram_tpu_torch.vm.cycle import vm_cycle


def test_composed_configuration_refusals():
    two = get_ntt_context(TWIDE.n, TWIDE.primes, "two_pass")
    assert not fused_path_active(two)
    assert two is not get_ntt_context(TWIDE.n, TWIDE.primes)
    with pytest.raises(ValueError):
        get_ntt_context(TWIDE.n, TWIDE.primes, "radix4")
    keys = tkeys.EvaluationKeysPrepared({}, {}, None)
    assert tram.FheRam(TWIDE, keys, device="cpu", composed=True).ctx is two
    with pytest.raises(ValueError):  # the trees have no two-pass body
        tram.FheRam(TWIDE, keys, device="cpu", composed=True, tree_kernels=True)
    ct = torch.zeros((1, 2, 3, 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        keyswitch.extract_slots(TWIDE, two, ct, 4, {}, tree=True)
    with pytest.raises(ValueError):
        packer.pack(TWIDE, two, ct[None].expand(4, -1, -1, -1, -1), {}, tree=True)
    with pytest.raises(ValueError):  # the VM's composed routes: not yet
        vm_cycle(TWIDE, two, keys, *([None] * 10))
