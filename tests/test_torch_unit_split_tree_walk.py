"""The walk of the split tree on the fold body (csrc/split_tree.cu
TreeSplitStep, split_tree_kernel; kernel 7): level l's row r is node j =
r mod 2^l of root b = r / 2^l; it reads its parent from ct (level 0) or
from the buffer level l - 1 wrote, and stores child0 at c0 = dst + (b *
dst_nodes + j) * row and child1 at c0 + 2^l * row, dst `out` (2^S nodes a
root) for the last level and the levels an even number before it, else
`tmp` (2^(S-1)); persistent clusters walk a level's rows r, r + clusters,
...  Emulated on index arrays at nb = 3, 4 and S = 1..6: every row of a
level is walked once, no level reads a row the same level writes (or a
child0 and a child1 land on one row), a level reads only what the level
before it wrote, and the last level writes every leaf of `out` once, in
ops/ntt_cuda.fused_split_tree_plain's concat layout (node j of root b is
the leaf for slot j), with the rotation and galois element the plain
version gives each level (ops/ntt_cuda._split_levels' t_back and g^-1).
The CPU tests never launch the kernel; this is its only check here.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import torch

from fhe_ram_tpu_torch.ops import ntt_cuda, poly
from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR

BIG = 1 << 8   # a node's code: root b * BIG + m, m = 1 at the root, 2m / 2m + 1 its children


def test_split_tree_walk_writes_every_leaf_once_in_the_concat_layout(monkeypatch):
    n = PAR.n
    levels = []

    def split(ctx, flat, t_rot, g, key):
        levels.append((t_rot, g))
        b, m = flat // BIG, flat % BIG
        return b * BIG + 2 * m, b * BIG + 2 * m + 1

    monkeypatch.setattr(ntt_cuda, "fused_split_plain", split)
    for nb in (3, 4):
        for S in range(1, 7):
            levels.clear()
            roots = torch.arange(nb, dtype=torch.int64) * BIG + 1
            want = ntt_cuda.fused_split_tree_plain(
                None, roots.reshape(nb, 1, 1, 1), PAR.trace_gal_els[:S],
                torch.zeros((S, 1)))
            want = want.reshape(nb, 1 << S)
            lv = ntt_cuda._split_levels(PAR.trace_gal_els[:S], n)
            assert lv.count == S
            for l, (t_rot, g) in enumerate(levels):
                assert lv.t_back[l] == -t_rot % (2 * n)
                assert lv.ginv[l] == poly.auto_inverse(n, g)

            def node(k, b, j):                                   # TreeSplitStep.node
                to_out = (S - 1 - k) % 2 == 0
                return ("out" if to_out else "tmp"), b * (1 << (S if to_out else S - 1)) + j

            buf = {"ct": {b: int(roots[b]) for b in range(nb)}, "out": {}, "tmp": {}}
            written = {("ct", b) for b in range(nb)}
            for l in range(S):
                for clusters in (1, 5, 88):                      # the deal
                    walked = sorted(r for k in range(clusters)
                                    for r in range(k, nb << l, clusters))
                    assert walked == list(range(nb << l))
                reads, writes, new = set(), [], {}
                for r in range(nb << l):
                    b, j = r >> l, r & ((1 << l) - 1)
                    src = ("ct", r) if l == 0 else node(l - 1, b, j)
                    assert src in written, (nb, S, l, r)
                    reads.add(src)
                    c0 = node(l, b, j)
                    c1 = (c0[0], c0[1] + (1 << l))              # c0 + 2^l rows
                    writes += [c0, c1]
                    x = buf[src[0]][src[1]]
                    new[c0], new[c1] = (x // BIG) * BIG + 2 * (x % BIG), (
                        x // BIG) * BIG + 2 * (x % BIG) + 1
                assert len(set(writes)) == len(writes), (nb, S, l)
                assert not reads & set(writes), (nb, S, l)
                for (name, at), v in new.items():
                    buf[name][at] = v
                written = set(writes)
            assert sorted(written) == [("out", i) for i in range(nb << S)]
            for b in range(nb):
                for j in range(1 << S):
                    assert buf["out"][b * (1 << S) + j] == int(want[b, j]), (nb, S, b, j)
