"""The exchange kernel's (csrc/collective.cu, kernel 14) grid and walk,
emulated: per blocks a shard from the wrapper's rule
(parallel/collective._exchange_blocks, at most the blocks the card holds
at once over all shards), block b serves shard b / per, and its threads walk 16-byte units
i0, i0 + step, ... (step = per * COLL_THREADS) EXCH_UNROLL at a time.
Every unit of every shard's chunk is read once and lands once in its XOR
partner's output at the same unit, at every shape of chip_smoke.py's
COLLECTIVE_SHAPES["exchange"] (the read's pack root at
PARAMS_2_24_READOPT) and at unit counts that are not a multiple of a
block, of a wave or of the unrolled step, on a full card and on one whose
single wave forces the block-stride loop.  The CPU tests never launch the
kernel; this is its only check here.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import re
from pathlib import Path

import numpy as np

from fhe_ram_tpu_torch.ops import ntt_cuda
from fhe_ram_tpu_torch.parallel import collective
from fhe_ram_tpu_torch.params import PARAMS_2_24_READOPT as BPAR

SRC = (Path(ntt_cuda.__file__).resolve().parent.parent / "csrc" / "collective.cu").read_text()
THREADS = int(re.search(r"#define COLL_THREADS (\d+)", SRC).group(1))
UNROLL = int(re.search(r"#define EXCH_UNROLL (\d+)", SRC).group(1))
# chip_smoke.py COLLECTIVE_SHAPES["exchange"]: (shards, pack roots a chunk, stride)
SHAPES = ((4, 1, 1), (4, 1, 2), (8, 1, 1), (8, 1, 2), (8, 1, 4))


def test_exchange_grid_moves_every_unit_once_to_its_partner():
    assert (collective.COLL_THREADS, collective.EXCH_UNROLL) == (THREADS, UNROLL)
    root = BPAR.word_size * (BPAR.rank + 1) * BPAR.limbs_ct * BPAR.n // 4
    odd = (5, THREADS * UNROLL + 7, 17 * THREADS * UNROLL + 3)
    cases = [(n, roots * root, stride, 132) for n, roots, stride in SHAPES]
    cases += [(n, units, stride, sms) for units in odd for sms in (132, 8)
              for n, stride in ((4, 2), (8, 1), (16, 8))]
    for n, units, stride, sms in cases:
        per = collective._exchange_blocks(n, units, sms)
        assert per >= 1 and (per * n <= 8 * sms or per == 1)
        step = per * THREADS
        block = np.arange(per * n)
        first = (block % per)[:, None] * THREADS + np.arange(THREADS)    # i0
        rounds = -(-units // (UNROLL * step))
        walk = (first[..., None, None] + UNROLL * step * np.arange(rounds)[:, None]
                + step * np.arange(UNROLL)).reshape(per * n, THREADS, -1)
        live = walk < units
        src = np.broadcast_to((block // per)[:, None, None], walk.shape)[live]
        unit = walk[live]
        reads = np.bincount(src * units + unit, minlength=n * units)
        assert (reads == 1).all(), (n, units, stride, sms)
        dst = np.bincount((src ^ stride) * units + unit, minlength=n * units)
        assert (dst == 1).all(), (n, units, stride, sms)
