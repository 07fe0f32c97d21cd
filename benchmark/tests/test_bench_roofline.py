"""The roofline counts at the shapes the kernel table prices."""

import json

import pytest

from benchmark import roofline
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def cfg(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())["params"]


def test_fold_ops_at_the_priced_shapes():
    # kernel 2 at B=256, T=4, M=6: 1.00 G operations -> 14.9 us at 67 T/s
    ops = roofline.fold_ops(256, 4, 6, 4096)
    assert ops == pytest.approx(1.00e9, rel=1e-3)
    assert ops / roofline.SCALAR_OPS_PER_S == pytest.approx(14.9e-6, rel=1e-2)
    # four chained digits at T=6, M=8: 5.90 G -> 88.0 us
    assert 4 * roofline.fold_ops(256, 6, 8, 4096) == pytest.approx(5.90e9, rel=2e-3)
    assert roofline.ntt_ops(4096) == 3 * 2048 * 12 + 4096


@pytest.mark.parametrize("name,op,launches", [
    ("readme_2_18", "read", {"fold": 2, "keyswitch": 7}),
    ("readme_2_18", "rmw", {"fold": 16, "keyswitch": 14, "ntt": 2}),
    ("readme_2_18", "read_batch", {"fold": 2, "keyswitch": 7, "ntt": 1}),
    ("code_2_14", "read_batch", {"fold": 2, "keyswitch": 3, "ntt": 1}),
    ("readme_2_18", "rmw_batch", {"fold": 8, "keyswitch": 13, "ntt": 3}),
])
def test_steps_a_call_match_the_servers_launches(name, op, launches):
    """As many steps a layer as the server launches kernels of it (a fold
    a level, a merge a pack level, a trace; the write's 14 folds, 6 splits,
    a trace and 2 transforms; the batched write's inversions one step for
    all addresses)."""
    got = {}
    for layer, b, o in roofline.call_launches(cfg(name), op, 64):
        assert b > 0 and o > 0
        got[layer] = got.get(layer, 0) + 1
    assert got == launches


def test_least_time_is_the_larger_bound():
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)
    t = roofline.layer_least_seconds(cfg("readme_2_18"), "read", "fold")
    # level 0: 5.90 G ops (88.0 us) + level 1: two chained digits over 4 rows
    assert 0.088e-3 < t < 0.092e-3
