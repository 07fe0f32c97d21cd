"""Closed loop of batched read-modify-writes: one client, back to back, each
`FheRam.rmw_batch` of `batch` distinct addresses, chained on the state the
last call returned.  Set-up encrypts a pool of distinct addresses and a
pool of words and stacks `batches` batches, each `batch` distinct pool
addresses with `batch` pool words, drawn from the seed; the calls take the
batches in an order drawn from the seed.  All reads of a call see the RAM
before its writes (those of a vectorised store).

Judged: the old words each kept call read out (a sample of the calls,
drawn from the seed), and every word of the RAM the last call left.

Parameters: batch, pool, words, batches, warmup, trace_steps, keep.
"""

from __future__ import annotations

import numpy as np

LATENCY_OP = "rmw_batch"
COUNT_OP = "rmw"
ROOFLINE_OP = "rmw_batch"


def batch(tp) -> int:
    return int(tp.get("batch", 16))


def addresses_per_step(tp) -> int:
    return batch(tp)


def setup(run, tp):
    import torch

    from fhe_ram_tpu_torch.convert import stack_addresses
    from fhe_ram_tpu_torch.ram import address as address_mod
    from fhe_ram_tpu_torch.ram import ram as ram_mod

    p, B = run.params, batch(tp)
    pool = run.distinct_addresses(max(B, int(tp.get("pool", B))))
    coeff = [address_mod.encrypt(p, run.ctx, run.s_ntt, int(a), run.source) for a in pool]
    prep = [address_mod.prepare(run.ctx, c) for c in coeff]
    words = run.random_words(max(B, int(tp.get("words", B))))
    w_cts = [ram_mod.encrypt_write_word(p, run.ctx, run.s_ntt, w, run.source) for w in words]
    stacks = []
    for _ in range(int(tp.get("batches", 2))):
        a = run.np_rng.permutation(len(pool))[:B]
        w = run.np_rng.permutation(len(words))[:B]
        stacks.append({"a": a, "w": w, "prep": stack_addresses([prep[j] for j in a]),
                       "coeff": stack_addresses([coeff[j] for j in a]),
                       "w_b": torch.stack([w_cts[j] for j in w])})
    del coeff, prep, w_cts
    return {"pool": pool, "words": words, "stacks": stacks, "log": [],
            "order": run.np_rng.integers(0, len(stacks), size=1 << 16)}


def step(run, ks, i):
    k = int(ks["order"][i % len(ks["order"])])
    s = ks["stacks"][k]
    outs, run.state = run.server.rmw_batch(run.state, s["prep"], s["coeff"], s["w_b"])
    ks["log"].append((i, k))
    return ks["pool"][s["a"]], outs


def collect(run, ks, steps, metas, answers):
    """Replays the calls on the plaintext RAM: each kept call's read-outs
    against the words before it, the last state against the RAM after all."""
    from benchmark.reference.ram_reference import PlainRam

    plain = PlainRam(run.ram_bytes, run.params.word_size)
    kept = set(steps)
    want = {}
    for i, k in ks["log"]:
        s = ks["stacks"][k]
        addrs = ks["pool"][s["a"]]
        if i in kept:
            want[i] = np.stack([plain.read(a) for a in addrs])
        for a, w in zip(addrs, s["w"]):
            plain.write(a, ks["words"][w])
    wants = np.concatenate([want[i] for i in steps])
    return [("answers", answers.reshape((-1,) + answers.shape[-4:]), wants),
            ("ram", run.state.data.cpu().numpy(), plain.words)]
