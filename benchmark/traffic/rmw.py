"""Closed loop of read-modify-write cycles: one client, back to back, each
cycle `FheRam.read_prepare_write` then `FheRam.write` at an address drawn
uniformly from a pool encrypted in set-up, writing a word drawn from a
pool of words encrypted in set-up (both drawn anew each cycle from the
seed), each cycle chained on the state the last write returned.

Judged: the old word each kept cycle read out (a sample of the cycles,
drawn from the seed), and every word of the RAM the last write left.

Parameters: pool (addresses), words (encrypted words), warmup,
trace_steps, keep.
"""

from __future__ import annotations

import numpy as np

LATENCY_OP = "rmw"
COUNT_OP = "rmw"
ROOFLINE_OP = "rmw"


def batch(tp) -> int:
    return 1


def addresses_per_step(tp) -> int:
    return 1


def setup(run, tp):
    from fhe_ram_tpu_torch.ram import address as address_mod
    from fhe_ram_tpu_torch.ram import ram as ram_mod

    p = run.params
    addrs = run.distinct_addresses(int(tp.get("pool", 64)))
    coeff = [address_mod.encrypt(p, run.ctx, run.s_ntt, int(a), run.source) for a in addrs]
    prep = [address_mod.prepare(run.ctx, c) for c in coeff]
    words = run.random_words(int(tp.get("words", 64)))
    w_cts = [ram_mod.encrypt_write_word(p, run.ctx, run.s_ntt, w, run.source)
             for w in words]
    n = 1 << 16
    return {"addrs": addrs, "coeff": coeff, "prep": prep, "words": words,
            "w_cts": w_cts, "a_order": run.np_rng.integers(0, len(addrs), size=n),
            "w_order": run.np_rng.integers(0, len(words), size=n), "log": []}


def step(run, ks, i):
    k = int(ks["a_order"][i % len(ks["a_order"])])
    w = int(ks["w_order"][i % len(ks["w_order"])])
    out, pend = run.server.read_prepare_write(run.state, ks["prep"][k])
    run.state = run.server.write(pend, ks["w_cts"][w], ks["coeff"][k])
    ks["log"].append((i, k, w))
    return ks["addrs"][k:k + 1], out[None]


def collect(run, ks, steps, metas, answers):
    """Replays the cycles on the plaintext RAM: each kept read-out against
    the word before its cycle, the last state against the RAM after all."""
    from benchmark.reference.ram_reference import PlainRam

    plain = PlainRam(run.ram_bytes, run.params.word_size)
    kept = set(steps)
    want = {}
    for i, k, w in ks["log"]:
        if i in kept:
            want[i] = plain.read(ks["addrs"][k])
        plain.write(ks["addrs"][k], ks["words"][w])
    wants = np.stack([want[i] for i in steps])
    return [("answers", answers.reshape((-1,) + answers.shape[-4:]), wants),
            ("ram", run.state.data.cpu().numpy(), plain.words)]
