"""How many blocks share one row of a launch, or of one level of a tree
launch (ops/ntt_cuda._row_blocks): 6 while the rows are few and the output
polys split evenly, 3 up to the card's SM count, 1 beyond; the per-level
kernels' shape argument takes the same choice.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

from fhe_ram_tpu_torch.ops import ntt_cuda


def test_blocks_a_row_follow_the_rows_of_the_launch():
    six, three = ntt_cuda._ROWS_CLUSTER_6, ntt_cuda._ROWS_CLUSTER_3
    assert (six, three) == (32, 128)
    for rows in (1, 4, six):
        assert ntt_cuda._row_blocks(rows, 8) == 6
        assert ntt_cuda._row_blocks(rows, 9) == 3    # 9 polys do not halve
    for rows in (six + 1, three):
        assert ntt_cuda._row_blocks(rows, 8) == 3
    assert ntt_cuda._row_blocks(three + 1, 8) == 1
    # a split tree of 4 roots: 4, 8, .., 128 rows a level
    assert [ntt_cuda._row_blocks(4 << l, 8) for l in range(6)] == [6, 6, 6, 6, 3, 3]
    # a pack tree of 32 leaves in 64 columns: 1024, 512, .., 64 row pairs
    assert [ntt_cuda._row_blocks((32 >> (s + 1)) * 64, 8) for s in range(5)] == [
        1, 1, 1, 3, 3]
    assert ntt_cuda.SHAPE_OVERRIDE is None
    for rows in (4, 64, 4096):
        sh = ntt_cuda._fold_shape(rows, 3, 8, 2, 3, -1, 4096)
        assert sh.cs == ntt_cuda._row_blocks(rows, 8) and sh.mc == 3
