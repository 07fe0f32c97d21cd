"""Readings of a cell's compared numbers over many seeds in one process:
the program as the configuration states it (`--mode sound`), or its
control (`--mode control`): the program with its own lower-precision path
switched on, one gadget limb fewer in every keyswitch (the `trunc` of the
port's `packer.pack` and `keyswitch.trace`: the input digits and the key
limbs each one step below the configuration's, as its read-truncated
presets run them) wherever the server leaves it off, in the read, rpw,
write and batched paths alike: the step that would tempt a later change.
The benchmark's own runs do not run it.

    python3 benchmark/control.py --workload <cell> --mode control --seeds 1,2,3 --seconds 3

Prints one JSON line a seed with the checks, and last a summary: the
largest reading of each number (the sound runs' lower reading) or the
smallest (the control's upper reading).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path


def control_trunc(params: dict):
    """(input digits, key limbs) one limb below the configuration's."""
    b = int(params.get("base2k", 17))
    return (-(-int(params["k_ct"]) // b) - 1, -(-int(params["k_evk_trace"]) // b) - 1)


@contextlib.contextmanager
def truncated_keyswitch(trunc_):
    """Every pack and trace called without a truncation runs with trunc_
    (the server passes it by keyword)."""
    from fhe_ram_tpu_torch.core import keyswitch, packer

    real_pack, real_trace = packer.pack, keyswitch.trace

    def pack(*args, trunc=(None, None), **kw):
        return real_pack(*args, trunc=trunc_ if trunc == (None, None) else trunc, **kw)

    def trace(*args, trunc=(None, None), **kw):
        return real_trace(*args, trunc=trunc_ if trunc == (None, None) else trunc, **kw)

    packer.pack, keyswitch.trace = pack, trace
    try:
        yield
    finally:
        packer.pack, keyswitch.trace = real_pack, real_trace


def readings(cell: str, seeds, seconds: float, mode: str, bench: dict,
             device="cuda", layout=None, log=None):
    """run_cell on every seed; returns [(seed, result)]."""
    import gc

    import torch

    from benchmark import harness

    layout = layout or harness.Layout()
    trunc = control_trunc(layout.config(layout.workload(cell)["config"])["params"])
    out = []
    for seed in seeds:
        with truncated_keyswitch(trunc) if mode == "control" else contextlib.nullcontext():
            r = harness.run_cell(cell, seed, seconds, False, time.time(), bench,
                                 device=device, layout=layout, log=log)
        out.append((seed, r))
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("sound", "control"), required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        sys.exit(2)
    bench = json.loads((Path.cwd() / "BENCHMARK.json").read_text())
    seeds = [int(s) for s in args.seeds.split(",")]
    res = readings(args.workload, seeds, args.seconds, args.mode, bench)
    for seed, r in res:
        print(json.dumps({"seed": seed, "mode": args.mode, "correct": r["correct"],
                          "metrics": r["metrics"], "checks": r["checks"]}), flush=True)
    pick = max if args.mode == "sound" else min
    summary = {name: pick(r["checks"][name]["value"] for _, r in res)
               for name in ("wrong_bytes", "noise_share")}
    print(json.dumps({"workload": args.workload, "mode": args.mode, "seeds": seeds,
                      "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
