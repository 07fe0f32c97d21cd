"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds BENCHMARK.json and the port
(`fhe_ram_tpu_torch`), on a machine with the cards the cell asks for.  The
last line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), `device`, with --trace 1 `breakdown`, and last
`checks`, each number compared with its limit; the same checks are the last
lines of standard error.  Without a card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded when the window has closed,
it prints no result and exits with another code than 0.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def fail(msg, code=1):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    bench_file = Path.cwd() / "BENCHMARK.json"
    if not bench_file.is_file():
        fail(f"no BENCHMARK.json in {Path.cwd()}")
    bench = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        fail(f"no cell {args.workload!r} in BENCHMARK.json")
    chips = int(cells[args.workload]["chips"])

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on the GPU only", 2)
    if torch.cuda.device_count() < chips:
        fail(f"the cell asks for {chips} cards, {torch.cuda.device_count()} present", 2)

    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START, bench, device="cuda")
    found = harness.forbidden_modules()
    if found:
        fail("JAX or the JAX package is loaded: " + ", ".join(found[:20]))
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = ""
    result_line = {k: v for k, v in result.items() if k != "checks"}
    result_line["card"] = smi.splitlines()[0] if smi else "not read"
    result_line["checks"] = result["checks"]
    lines = harness.check_lines(result["checks"])
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result_line), flush=True)


if __name__ == "__main__":
    main()
