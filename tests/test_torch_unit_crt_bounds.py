"""ops/crt.py's exactness contract in the port: the accumulation bound of
a fold and the capacity of a CRT basis, the JAX package's functions value
for value, and the default basis above the bound at the full gadget."""

import math

from fhe_ram_tpu.ops import crt as jcrt

from fhe_ram_tpu_torch.ops import crt as tcrt
from fhe_ram_tpu_torch.params import DEFAULT_PRIMES


def test_bounds_equal_the_reference_and_the_default_basis_holds():
    for t_rows in (1, 2, 3, 6, 8, 16):
        for n in (64, 512, 4096):
            for base2k in (13, 17):
                assert (tcrt.accumulation_bound_log2(t_rows, n, base2k)
                        == jcrt.accumulation_bound_log2(t_rows, n, base2k))
    for primes in (DEFAULT_PRIMES, DEFAULT_PRIMES[:2], (12289,), (786433, 40961)):
        assert tcrt.basis_capacity_log2(primes) == jcrt.basis_capacity_log2(primes)
    assert tcrt.accumulation_bound_log2(8, 4096) == 47.0
    assert tcrt.basis_capacity_log2(DEFAULT_PRIMES) > tcrt.accumulation_bound_log2(8, 4096)
    assert tcrt.basis_capacity_log2(DEFAULT_PRIMES[:2]) < tcrt.accumulation_bound_log2(2, 4096)
    assert math.isclose(tcrt.basis_capacity_log2(DEFAULT_PRIMES), 57.4, abs_tol=0.05)
