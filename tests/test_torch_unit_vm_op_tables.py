"""The VM's op tables of the PyTorch port equal the JAX package's: the
RV32I op enum, the immediate ops, the carry-DP specs, the bitwise truth
tables, the shift kinds and the store ops -- and the carry chain kernel's
leaf rows (`ntt_cuda.dp_leaf_rows`) equal the TPU kernel's
`_dp_leaf_tables` for every op, (a, c) and step.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

from fhe_ram_tpu.ops.ntt_pallas import _dp_leaf_tables
from fhe_ram_tpu.vm import arithmetic as jar
from fhe_ram_tpu.vm import store as jstore

from fhe_ram_tpu_torch.ops import ntt_cuda
from fhe_ram_tpu_torch.vm import arithmetic as tar
from fhe_ram_tpu_torch.vm import store as tstore


def test_op_tables_and_leaf_rows_equal_the_reference():
    assert tar.RVI32_OPS == jar.RVI32_OPS
    assert tar._IMM_OPS == jar._IMM_OPS
    assert tar._BITWISE_TABLES == jar._BITWISE_TABLES
    assert tar._SHIFT_KINDS == jar._SHIFT_KINDS
    assert tstore.STORE_OPS == jstore.STORE_OPS
    assert tar._DP_SPECS.keys() == jar._DP_SPECS.keys()
    for op, ref in jar._DP_SPECS.items():
        got = tar._DP_SPECS[op]
        assert got[:3] == ref[:3] and got[4] == ref[4], op
        assert [got[3](c) for c in (0, 1)] == [ref[3](c) for c in (0, 1)], op
        for first in (False, True):
            rows = ntt_cuda.dp_leaf_rows(*got[:3], first)
            for r, (a, c) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                assert rows[r] == _dp_leaf_tables(*ref[:3], a, c, first), (op, a, c)
    ops = jar.RVI32_OPS
    assert tar._src_groups(ops) == jar._src_groups(ops)
