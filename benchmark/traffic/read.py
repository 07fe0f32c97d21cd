"""Closed loop of single reads: one client, back to back, each
`FheRam.read` at an address drawn uniformly from a pool encrypted in
set-up, in an order drawn from the seed.  Every read touches every row, so
the address distribution does not change the work.

Parameters: pool (addresses encrypted in set-up), warmup (reads before the
window), trace_steps (reads in the traced stretch), keep (reads whose
answers are judged, a sample drawn from the seed).
"""

from __future__ import annotations

import numpy as np

LATENCY_OP = "read"
COUNT_OP = "read"
ROOFLINE_OP = "read"


def batch(tp) -> int:
    return 1


def addresses_per_step(tp) -> int:
    return 1


def setup(run, tp):
    from fhe_ram_tpu_torch.ram import address as address_mod

    addrs = run.distinct_addresses(int(tp.get("pool", 64)))
    prep = [address_mod.prepare(run.ctx, address_mod.encrypt(
        run.params, run.ctx, run.s_ntt, int(a), run.source)) for a in addrs]
    order = run.np_rng.integers(0, len(addrs), size=1 << 16)
    return {"addrs": addrs, "prep": prep, "order": order}


def step(run, ks, i):
    k = int(ks["order"][i % len(ks["order"])])
    out = run.server.read(run.state, ks["prep"][k])
    return ks["addrs"][k:k + 1], out[None]


def collect(run, ks, steps, metas, answers):
    """The kept answers and the words the RAM holds at their addresses."""
    addrs = np.concatenate(metas)
    words = run.ram_bytes.reshape(-1, run.params.word_size)
    return [("answers", answers.reshape((-1,) + answers.shape[-4:]), words[addrs])]
