"""BENCHMARK.json against the benchmark's contract, and every file it
names present; the configurations are the port's named presets."""

import json
import re
from pathlib import Path

import pytest

from benchmark import stats
from benchmark.harness import Layout

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    assert (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_whys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    from benchmark.harness import cell_metrics

    for w in BENCH["workloads"]:
        e2e, layer = cell_metrics(BENCH, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer
        assert w["chips"] == 1


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files(w):
    lay = Layout()
    cell = lay.workload(w["name"])
    assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
    assert lay.config(w["config"])
    assert lay.traffic(cell["kind"])
    assert 0 < cell["limits"]["noise_share"] < 1
    e2e = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
    for m in e2e:
        if m["name"] != "setup_s":
            stats.end_to_end(m["name"], {}, {}, 1.0)   # a statistic the name defines
    for m in BENCH["per_layer"]:
        assert callable(lay.layer_metric(m["name"]).read)


@pytest.mark.parametrize("name,preset", [("readme_2_18", "PARAMS_README_2_18"),
                                         ("code_2_14", "PARAMS_CODE_2_14")])
def test_configurations_are_the_ports_presets(name, preset):
    from fhe_ram_tpu_torch import params as P

    cfg = Layout().config(name)
    got = P.Params(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in cfg["params"].items()})
    assert got == getattr(P, preset)
    assert cfg["reduced"] == [] and cfg["server"] == {"tree_kernels": False, "composed": False}
