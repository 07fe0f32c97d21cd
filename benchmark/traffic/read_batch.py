"""Closed loop of batched reads: one client, back to back, each
`FheRam.read_batch` of `batch` distinct addresses.  Set-up encrypts a pool
of distinct addresses and stacks `batches` batches of them, each a sample
of `batch` distinct pool addresses drawn from the seed; the calls take the
batches in an order drawn from the seed.

Parameters: batch, pool, batches, warmup, trace_steps, keep (calls whose
answers are judged, a sample drawn from the seed).
"""

from __future__ import annotations

import numpy as np

LATENCY_OP = "read_batch"
COUNT_OP = "read"
ROOFLINE_OP = "read_batch"


def batch(tp) -> int:
    return int(tp.get("batch", 64))


def addresses_per_step(tp) -> int:
    return batch(tp)


def setup(run, tp):
    from fhe_ram_tpu_torch.convert import stack_addresses
    from fhe_ram_tpu_torch.ram import address as address_mod

    A = batch(tp)
    pool = run.distinct_addresses(max(A, int(tp.get("pool", A))))
    prep = [address_mod.prepare(run.ctx, address_mod.encrypt(
        run.params, run.ctx, run.s_ntt, int(a), run.source)) for a in pool]
    picks = [run.np_rng.permutation(len(pool))[:A]
             for _ in range(int(tp.get("batches", 2)))]
    stacks = [stack_addresses([prep[j] for j in pick]) for pick in picks]
    del prep
    order = run.np_rng.integers(0, len(stacks), size=1 << 16)
    return {"addrs": [pool[p] for p in picks], "stacks": stacks, "order": order}


def step(run, ks, i):
    k = int(ks["order"][i % len(ks["order"])])
    return ks["addrs"][k], run.server.read_batch(run.state, ks["stacks"][k])


def collect(run, ks, steps, metas, answers):
    """The kept answers and the words the RAM holds at their addresses."""
    addrs = np.concatenate(metas)
    words = run.ram_bytes.reshape(-1, run.params.word_size)
    return [("answers", answers.reshape((-1,) + answers.shape[-4:]), words[addrs])]
