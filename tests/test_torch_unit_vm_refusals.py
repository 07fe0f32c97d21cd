"""What the VM's entry points and chain wrappers refuse, on the CPU: a
word width that does not tile the ring (its slots would alias), more
packed ops than the slot stride holds, a pointer prepared at the wrong
parameterization, a word that is not whole bytes, a cycle whose word is
not the RAM's, and chain arguments the kernels do not take.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import pytest
import torch

from fhe_ram_tpu_torch.params import PARAMS_TEST_SMALL as PAR
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context
from fhe_ram_tpu_torch.ops import ntt_cuda
from fhe_ram_tpu_torch.vm import arithmetic, conversion, cycle, fheuint


def test_vm_refuses_what_it_cannot_compute():
    ctx = get_ntt_context(PAR.n, PAR.primes)
    i32 = torch.int32
    assert fheuint.gap(PAR, 32) == 2 and fheuint.gap(PAR, 4) == 16
    for bits in (3, 48, 128, 0):
        with pytest.raises(ValueError):
            fheuint.gap(PAR, bits)
    word = torch.zeros((2, 3, 64), dtype=i32)
    prep = torch.zeros((3, 4, 3, 2, 2, 4, 64), dtype=i32)
    with pytest.raises(ValueError):          # 17 ops at a stride of 16
        arithmetic.eval_ops(PAR, ctx, prep, prep, prep, {}, ("none",) * 17, 4)
    with pytest.raises(ValueError):
        arithmetic.select_rd(PAR, ctx, word, prep, 17, {}, 4)
    with pytest.raises(ValueError):          # not an ALU op
        arithmetic.eval_ops(PAR, ctx, prep, prep, prep, {}, ("none", "mul"), 4)
    with pytest.raises(ValueError):          # bits at the ct-level dnum
        conversion.fheuint_to_address(PAR, ctx, prep)
    with pytest.raises(ValueError):
        cycle.word_to_ram_bytes(PAR, ctx, word, {}, 4)
    with pytest.raises(ValueError):          # the RAM's words are 2 bytes
        cycle.vm_cycle(PAR, ctx, None, prep, prep, prep, prep, word, word, prep,
                       prep, prep, None, bits=32)

    rows = torch.zeros((2, 2, 3, 64), dtype=i32)
    keys = torch.zeros((2, 3, 4, 6, 64), dtype=i32)
    assert ntt_cuda.fused_blind_rotate(ctx, rows, keys, (1, -1)).shape == rows.shape
    with pytest.raises(ValueError):          # more amounts than keys
        ntt_cuda.fused_blind_rotate(ctx, rows, keys, (1, 2, 3))
    with pytest.raises(ValueError):          # more digits than the rows have limbs
        ntt_cuda.fused_blind_rotate(ctx, rows, torch.zeros((2, 3, 8, 6, 64), dtype=i32),
                                    (1, 2))
    with pytest.raises(ValueError):          # key limbs that do not split over C2
        ntt_cuda.fused_blind_rotate(ctx, rows, keys[:, :, :, :5], (1, 2))
    F0 = torch.zeros((3, 2, 2, 3, 64), dtype=i32)
    dk = torch.zeros((4, 3, 3, 4, 6, 64), dtype=i32)
    deltas = torch.zeros((4, 2, 3, 64), dtype=i32)
    tabs = ((True, False, False),) * 3
    with pytest.raises(ValueError):          # groups that miss op 2
        ntt_cuda.fused_dp_chain(ctx, F0, dk, deltas, tabs, ((0,), (1,)))
    with pytest.raises(ValueError):          # keys for 2 groups, 1 given
        ntt_cuda.fused_dp_chain(ctx, F0, dk, deltas, tabs, ((0, 1, 2),))
    with pytest.raises(ValueError):          # a delta per step
        ntt_cuda.fused_dp_chain(ctx, F0, dk, deltas[:3], tabs, ((0,), (1, 2)))
    hi = torch.zeros((3, 2, 2, 3, 64), dtype=i32)
    with pytest.raises(ValueError):
        ntt_cuda.fused_bitwise(ctx, hi, hi[:2], dk, ((0,), (1, 2)))
    with pytest.raises(ValueError):
        ntt_cuda.fused_bitwise(ctx, hi, hi, dk, ((0, 1), (1, 2)))
    with pytest.raises(ValueError):          # more ops than one launch takes
        ntt_cuda.fused_bitwise(ctx, torch.zeros((17, 2, 2, 3, 64), dtype=i32),
                               torch.zeros((17, 2, 2, 3, 64), dtype=i32), dk,
                               (tuple(range(17)),))
