"""Shared set-up of the benchmark's own tests: the repository root on the
path, the `chip` marker, and a small layout (a configuration at the port's
PARAMS_TEST_SMALL sizes and a cell of each traffic kind on it) that runs on
the CPU through the port's plain versions."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

SMALL_PARAMS = {"log_n": 6, "base2k": 17, "rank": 1, "k_pt": 3, "k_ct": 51, "k_ggsw": 68,
                "k_evk_trace": 68, "k_evk_ggsw": 85, "decomp_n": [3, 3], "word_size": 2,
                "max_addr": 256, "primes": [786433, 737281, 638977], "xs_density": 0.5,
                "sigma": 3.2}
# the small cells' noise limit, from test_bench_control.py's readings on the
# CPU: the program 5e-12 .. 2.7e-11, its control 1.5e-7 .. 3.3e-7 (three seeds)
SMALL_NOISE_LIMIT = 1e-8
KINDS = {"read": "read_p50_ms", "rmw": "rmw_p95_ms", "read_batch": "reads_per_s",
         "rmw_batch": "rmws_per_s"}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


def write_small_layout(root: Path, limit: float = SMALL_NOISE_LIMIT):
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "workloads").mkdir(exist_ok=True)
    (root / "configs" / "small.json").write_text(json.dumps(
        {"name": "small", "source": "test sizes", "params": SMALL_PARAMS,
         "server": {"tree_kernels": False, "composed": False}, "reduced": []}))
    for kind in KINDS:
        (root / "workloads" / f"small.{kind}.json").write_text(json.dumps(
            {"config": "small", "traffic": kind, "kind": kind,
             "params": {"pool": 8, "words": 8, "batch": 4, "batches": 2, "warmup": 1,
                        "trace_steps": 2, "keep": 16},
             "limits": {"noise_share": limit}, "why": "test"}))


def small_bench():
    """BENCHMARK.json with a small cell of each traffic kind added to the
    metrics of its kind, and every end-to-end metric of a kind in it."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] += [{"name": f"small.{k}", "config": "small", "traffic": k,
                            "chips": 1, "why": "test"} for k in KINDS]
    have = {m["name"] for m in bench["end_to_end"]}
    for kind, metric in KINDS.items():
        if metric not in have:
            unit = "rmws/s" if metric.endswith("_per_s") else "ms"
            bench["end_to_end"].append({"name": metric, "unit": unit, "better": "lower",
                                        "bound": 0.25, "source": "host_clock",
                                        "workloads": []})
    for m in bench["end_to_end"]:
        for kind, metric in KINDS.items():
            if m["name"] in (metric, "read_p95_ms" if kind == "read" else None):
                m["workloads"].append(f"small.{kind}")
    moves = {m["name"]: m["workloads"] for m in bench["end_to_end"] if "workloads" in m}
    for m in bench["per_layer"]:
        m["workloads"] = sorted(set(m["workloads"]) | {
            c for c in moves.get(m["moves"], []) if c.startswith("small.")})
    return bench


@pytest.fixture
def small(tmp_path):
    from benchmark import harness

    write_small_layout(tmp_path)
    return harness.Layout(tmp_path), small_bench(), tmp_path
