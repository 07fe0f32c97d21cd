"""The walk of the pack tree on the fold body (csrc/pack_tree.cu
TreeBuffers, TreeRows, pack_tree_kernel; kernel 8): level s's row pair r reads rows
r and r + R * nb (R = M >> (s + 1)) of its source, the leaves `cts` at
level 0, else the buffer level s - 1 wrote, and writes row r of its
destination: `out` for the last level, else half s & 1 of `tmp` (M/2 * nb
rows, then M/4 * nb).  The pairs of all levels form one list that
persistent clusters deal (items k, k + clusters, ...); item i is pair r of
level s, and a pair of level s > 0 waits on the counters of the two items
of level s - 1 that wrote its rows.  Emulated on index arrays at nb = 3, 4
and M = 2..32: every item is walked once and decodes to its level's pair,
each wait is on an earlier item of the level before (so every wait ends)
whose counter exists, a pair reads only what the level before it wrote,
and writes a row only after the one pair that read it there is done; no
level reads a row it writes (nor writes one twice, nor past its half); the
last level writes every root of `out` once, each the root
ops/ntt_cuda.fused_pack_tree_plain computes (its merges stubbed by a hash
of their operands), with the rotation and galois element the plain version
gives each level (ops/ntt_cuda._pack_levels' rot and g^-1).  The CPU tests
never launch the kernel; this is its only check here.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import torch

from fhe_ram_tpu_torch.ops import ntt_cuda, poly
from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR

Q = (1 << 31) - 1   # a merge's stub: (a * 65599 + b * 31 + 7 s) mod Q, ordered in a, b


def _merge(a, b, s):
    return (a * 65599 + b * 31 + 7 * s) % Q


def test_pack_tree_walk_writes_every_root_once_from_the_levels_before(monkeypatch):
    n = PAR.n
    levels_seen = []

    def merge(ctx, A, B, t_rot, g, key):
        levels_seen.append((t_rot, g))
        return _merge(A, B, len(levels_seen) - 1)

    monkeypatch.setattr(ntt_cuda, "fused_pack_merge_plain", merge)
    for nb in (3, 4):
        for M in (2, 4, 8, 16, 32):
            levels = M.bit_length() - 1
            levels_seen.clear()
            leaves = torch.arange(M * nb, dtype=torch.int64).reshape(M, nb) * 1009 + 17
            want = ntt_cuda.fused_pack_tree_plain(   # n wide: g is n / t + 1
                None, leaves.reshape(M, nb, 1, 1, 1).expand(M, nb, 1, 1, n),
                torch.zeros((levels, 1)))
            assert bool((want == want[..., :1]).all())
            want = want[..., 0].reshape(nb)
            lv = ntt_cuda._pack_levels(levels, n)
            assert lv.count == levels == len(levels_seen)
            for s, (t_rot, g) in enumerate(levels_seen):
                assert lv.rot[s] == t_rot % (2 * n)
                assert lv.ginv[s] == poly.auto_inverse(n, g)

            def buf(k):                                          # TreeBuffers.buf
                return "out" if k == levels - 1 else ("tmp1" if k & 1 else "tmp0")

            rows_of = {"out": nb, "tmp0": M // 2 * nb, "tmp1": M // 4 * nb}
            data = {"cts": {r: int(leaves.reshape(-1)[r]) for r in range(M * nb)},
                    "out": {}, "tmp0": {}, "tmp1": {}}
            items = (M - 1) * nb
            for clusters in (1, 5, 88):                          # the deal
                walked = sorted(i for k in range(clusters) for i in range(k, items, clusters))
                assert walked == list(range(items))
            item_of, reader = {}, {}                             # (s, r) -> i; row -> its reader
            for i in range(items):                               # TreeRows.item
                s = 0
                while i >= (M - (M >> (s + 1))) * nb:
                    s += 1
                item_of[s, i - (M - (M >> s)) * nb] = i
            assert sorted(item_of) == [(s, r) for s in range(levels)
                                       for r in range((M >> (s + 1)) * nb)]
            written = {("cts", r) for r in range(M * nb)}
            for s in range(levels):
                rows = (M >> (s + 1)) * nb
                src = "cts" if s == 0 else buf(s - 1)            # TreeBuffers.src_a
                reads, writes, new = set(), [], {}
                for r in range(rows):
                    i = item_of[s, r]
                    a, b = (src, r), (src, r + rows)             # TreeBuffers.src_a, src_b
                    assert a in written and b in written, (nb, M, s, r)
                    if s > 0:                                    # TreeRows.wait
                        prev = (M - (M >> (s - 1))) * nb
                        waits = {prev + r, prev + r + rows}
                        assert waits == {item_of[s - 1, r], item_of[s - 1, r + rows]}
                        assert max(waits) < i and max(waits) < max(1, (M - 2) * nb)
                    reads |= {a, b}
                    dst = (buf(s), r)                            # TreeRows.dst
                    if dst in reader:                            # its reader is waited on
                        assert s > 0 and reader[dst] in waits, (nb, M, s, r)
                    assert r < rows_of[dst[0]], (nb, M, s, r)
                    writes.append(dst)
                    new[dst] = _merge(data[src][r], data[src][r + rows], s)
                assert len(set(writes)) == len(writes), (nb, M, s)
                assert not reads & set(writes), (nb, M, s)
                for r in range(rows):
                    reader[src, r] = reader[src, r + rows] = item_of[s, r]
                for (name, at), v in new.items():
                    data[name][at] = v
                written = set(writes)
            assert sorted(written) == [("out", b) for b in range(nb)]
            for b in range(nb):
                assert data["out"][b] == int(want[b]), (nb, M, b)
