"""The control at the small sizes: the program with its own lower-precision
keyswitch (one limb fewer in every pack's and trace's input digits and key
limbs) reads a noise share above the small cells' limit on every seed, the
program as configured below it."""

import pytest

from benchmark import control
from benchmark.tests.conftest import SMALL_NOISE_LIMIT

SEEDS = [2**31 + 1, 2**31 + 2, 2**31 + 3]


def test_the_control_steps_one_limb_down():
    from fhe_ram_tpu_torch.core import keyswitch, packer

    assert control.control_trunc({"k_ct": 51, "k_evk_trace": 68, "base2k": 17}) == (2, 3)
    real = packer.pack, keyswitch.trace
    with control.truncated_keyswitch((2, 3)):
        assert (packer.pack, keyswitch.trace) != real
    assert (packer.pack, keyswitch.trace) == real


@pytest.mark.parametrize("kind", ["read", "rmw", "read_batch", "rmw_batch"])
def test_the_control_fails_and_the_program_passes(small, kind):
    layout, bench, _ = small
    sound = control.readings(f"small.{kind}", SEEDS, 0.2, "sound", bench, device="cpu",
                             layout=layout, log=lambda m: None)
    ctrl = control.readings(f"small.{kind}", SEEDS, 0.2, "control", bench, device="cpu",
                            layout=layout, log=lambda m: None)
    low = max(r["checks"]["noise_share"]["value"] for _, r in sound)
    high = min(r["checks"]["noise_share"]["value"] for _, r in ctrl)
    assert all(r["correct"] for _, r in sound)
    assert not any(r["correct"] for _, r in ctrl)
    assert low < SMALL_NOISE_LIMIT < high and high > 3 * low
