"""A configuration, a cell, a traffic kind and a per-layer metric are added
by adding files: dropped into a directory the harness is pointed at, they
are found by name with no edit of any file that is there."""

import json
import shutil
from pathlib import Path

from benchmark import harness
from benchmark.tests.conftest import SMALL_PARAMS

BENCH = Path(__file__).resolve().parents[1]


def test_new_files_are_found_by_name(small, tmp_path):
    layout, bench, root = small
    # a new configuration and a cell of it on an existing traffic kind
    p = dict(SMALL_PARAMS, max_addr=128)
    (root / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "source": "test", "params": p, "server": {}, "reduced": []}))
    (root / "workloads" / "tiny.read.json").write_text(json.dumps(
        {"config": "tiny", "traffic": "read", "kind": "read",
         "params": {"pool": 4, "warmup": 1, "trace_steps": 2, "keep": 8},
         "limits": {"noise_share": 1e-8}, "why": "test"}))
    # a new traffic kind: the read kind under another name, with a counter
    (root / "traffic").mkdir()
    shutil.copy(BENCH / "traffic" / "read.py", root / "traffic" / "read_again.py")
    (root / "workloads" / "tiny.read_again.json").write_text(json.dumps(
        {"config": "tiny", "traffic": "read_again", "kind": "read_again",
         "params": {"pool": 4, "warmup": 1, "trace_steps": 3, "keep": 8},
         "limits": {"noise_share": 1e-8}, "why": "test"}))
    # a new per-layer metric
    (root / "layer_metrics").mkdir()
    (root / "layer_metrics" / "steps_traced.py").write_text(
        "def read(r):\n    return float(r.steps)\n")
    cells = ["tiny.read", "tiny.read_again"]
    bench["workloads"] += [{"name": c, "config": "tiny", "traffic": c.split(".")[1],
                            "chips": 1, "why": "test"} for c in cells]
    for m in bench["end_to_end"]:
        if m["name"] in ("read_p50_ms", "read_p95_ms"):
            m["workloads"] += cells
    bench["per_layer"].append({"name": "steps_traced.read", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "server entry", "moves": "read_p50_ms",
                               "workloads": cells})
    before = {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    for cell, steps in (("tiny.read", 2.0), ("tiny.read_again", 3.0)):
        r = harness.run_cell(cell, 3, 0.2, True, 0.0, bench, device="cpu",
                             layout=harness.Layout(root), log=lambda m: None)
        assert r["correct"], r["checks"]
        assert r["metrics"]["steps_traced.read"]["value"] == steps
        r = harness.run_cell(cell, 3, 0.2, False, 0.0, bench, device="cpu",
                             layout=harness.Layout(root), log=lambda m: None)
        assert set(r["metrics"]) == {"read_p50_ms", "read_p95_ms", "setup_s"}
    after = {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert before == after


def test_a_family_file_serves_every_suffix(small):
    layout, _, _ = small
    for name in ("launches_per_op.read", "launches_per_op.batch", "device_idle_pct.rmw"):
        assert callable(layout.layer_metric(name).read)


def test_metrics_of_a_cell_follow_benchmark_json(small):
    _, bench, _ = small
    e2e, layer = harness.cell_metrics(bench, "readme_2_18.rmw_batch16")
    assert [m["name"] for m in e2e] == ["rmws_per_s", "setup_s"]
    assert {m["name"] for m in layer} == {
        "launches_per_op.rmw", "fold_roofline_pct.rmw", "keyswitch_roofline_pct.rmw",
        "device_idle_pct.rmw"}
