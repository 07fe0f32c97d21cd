"""The all-gather kernel's (csrc/collective.cu, kernel 13) index arithmetic:
its launch (blocks a shard from blocks_per_shard, n groups) and each
thread's (slot, 16-byte unit) walk, emulated, write every unit of every
shard's output exactly once and read every unit of every input exactly
once, for 2 to 16 shards, with and without the block-stride loop.  The
CPU tests never launch the kernel; this is its only check here.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import re
from pathlib import Path

import numpy as np

from fhe_ram_tpu_torch.ops import ntt_cuda

SRC = (Path(ntt_cuda.__file__).resolve().parent.parent / "csrc" / "collective.cu").read_text()
THREADS = int(re.search(r"#define COLL_THREADS (\d+)", SRC).group(1))
MAX_BLOCKS = int(re.search(r"#define COLL_MAX_BLOCKS (\d+)", SRC).group(1))


def blocks_per_shard(words, cap):
    """csrc/collective.cu blocks_per_shard, its cap (COLL_MAX_BLOCKS there)
    a parameter here, so that a small chunk reaches the block-stride loop."""
    want = min(-(-(words // 4) // THREADS), cap)
    return max(want, 1)


def test_push_launch_writes_every_unit_once():
    assert ntt_cuda.MAX_SHARDS == int(re.search(r"#define FHE_MAX_SHARDS (\d+)", SRC).group(1))
    for n in range(2, ntt_cuda.MAX_SHARDS + 1):
        # 16-byte units: one partial block; several blocks, the last
        # partial; the same with the cap at 2 blocks (a block-stride loop)
        for units, cap in ((5, MAX_BLOCKS), (3 * THREADS + 7, MAX_BLOCKS),
                           (3 * THREADS + 7, 2)):
            words = 4 * units
            per = blocks_per_shard(words, cap)
            block = np.arange(per * n)
            s = block // per                              # the source slot
            first = (block % per)[:, None] * THREADS + np.arange(THREADS)
            walk = first[..., None] + per * THREADS * np.arange(-(-units // (per * THREADS)) + 1)
            live = walk < units
            slot = np.broadcast_to(s[:, None, None], walk.shape)[live]
            unit = walk[live]
            reads = np.bincount(slot * units + unit, minlength=n * units)
            assert (reads == 1).all(), (n, units, cap)
            # each read unit is stored into slot s of every shard k's output
            k = np.arange(n)[:, None]
            writes = np.bincount((k * n * units + slot * units + unit).reshape(-1),
                                 minlength=n * n * units)
            assert (writes == 1).all(), (n, units, cap)
