"""A whole run at the small sizes on the CPU (the look for a card skipped)
with the timed path broken underneath: `correct` has to come out false for
each fault the cells can have, and true without one."""

import pytest
import torch

from benchmark import harness
from fhe_ram_tpu_torch.ram import ram as ram_mod


def run(small, kind, seconds=0.3, trace=False):
    layout, bench, _ = small
    return harness.run_cell(f"small.{kind}", 2**31 + 11, seconds, trace, 0.0, bench,
                            device="cpu", layout=layout, log=lambda m: None)


@pytest.mark.parametrize("kind", ["read", "rmw", "read_batch", "rmw_batch"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_runs_are_correct(small, kind, trace):
    r = run(small, kind, trace=trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    if trace:
        assert r["checks"]["lost_kernels"]["value"] == 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_write_that_returns_its_state_unchanged(small, monkeypatch):
    def write(self, state, w, addr):
        return ram_mod.RamState(data=state.data, tree=(), pending=False)

    monkeypatch.setattr(ram_mod.FheRam, "write", write)
    r = run(small, "rmw")
    assert not r["correct"] and r["checks"]["wrong_bytes"]["value"] > 0


def test_a_batched_rmw_that_returns_its_state_unchanged(small, monkeypatch):
    real = ram_mod.FheRam.rmw_batch

    def rmw_batch(self, state, *a):
        outs, _ = real(self, state, *a)
        return outs, state

    monkeypatch.setattr(ram_mod.FheRam, "rmw_batch", rmw_batch)
    r = run(small, "rmw_batch")
    assert not r["correct"] and r["checks"]["wrong_bytes"]["value"] > 0


def test_half_of_the_batch_left_out(small, monkeypatch):
    real = ram_mod.FheRam.read_batch

    def read_batch(self, state, addrs, cache=None, batch_slice=64):
        A = addrs[0].shape[0]
        half = real(self, state, tuple(c[: A // 2] for c in addrs), cache, batch_slice)
        return torch.cat([half, half], dim=0)

    monkeypatch.setattr(ram_mod.FheRam, "read_batch", read_batch)
    r = run(small, "read_batch")
    assert not r["correct"] and r["failed"] > 0


def test_half_of_the_batched_rmw_left_out(small, monkeypatch):
    """The first half of the addresses read and written, its read-outs
    given for the whole batch."""
    real = ram_mod.FheRam.rmw_batch

    def rmw_batch(self, state, prep, coeff, w_b):
        B = w_b.shape[0]
        outs, new = real(self, state, tuple(c[: B // 2] for c in prep),
                         tuple(c[: B // 2] for c in coeff), w_b[: B // 2])
        return torch.cat([outs, outs], dim=0), new

    monkeypatch.setattr(ram_mod.FheRam, "rmw_batch", rmw_batch)
    r = run(small, "rmw_batch")
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("kind", ["read", "rmw", "read_batch", "rmw_batch"])
def test_an_answer_altered_where_it_is_produced(small, monkeypatch, kind):
    """One plaintext step added to byte 0 of every answer."""
    name = {"read": "read", "rmw": "read_prepare_write", "read_batch": "read_batch",
            "rmw_batch": "rmw_batch"}[kind]
    real = getattr(ram_mod.FheRam, name)

    def altered(self, *a, **k):
        out = real(self, *a, **k)
        ct = out[0] if isinstance(out, tuple) else out
        ct = ct.clone()
        ct[..., 0, self.params.rank, 0, 0] += 1 << (17 - self.params.k_pt)
        return (ct, out[1]) if isinstance(out, tuple) else ct

    monkeypatch.setattr(ram_mod.FheRam, name, altered)
    r = run(small, kind)
    assert not r["correct"] and r["checks"]["wrong_bytes"]["value"] > 0
