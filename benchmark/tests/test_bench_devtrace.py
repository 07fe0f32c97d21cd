"""The trace reading on a synthetic Chrome trace: busy time as the union
of device intervals inside the stretch, kernels by bare name, the launch
count, idle gaps named by the host operation at their middle."""

import pytest

from benchmark import devtrace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev(devtrace.STRETCH, "user_annotation", 100.0, 100.0),
    ev("void fold_kernel<2>(int const*, unsigned int const*)", "kernel", 110.0, 30.0),
    ev("void trace_kernel<1>(int const*)", "kernel", 130.0, 20.0),       # overlaps
    ev("void at::native::vectorized_elementwise_kernel<4>(int)", "kernel", 170.0, 10.0),
    ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 190.0, 5.0),
    ev("void fold_kernel<2>(int const*)", "kernel", 50.0, 10.0),          # before
    ev("aten::cat", "cpu_op", 150.0, 20.0),
    ev("read.step", "user_annotation", 100.0, 100.0),
    ev("cudaLaunchKernel", "cuda_runtime", 158.0, 4.0),
]


def test_busy_launches_and_names():
    tr = devtrace.Trace(EVENTS)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx((40 + 10 + 5) * 1e-6)
    assert tr.port_launches() == 2
    assert tr.kernel_seconds({"fold_kernel"}) == pytest.approx(30e-6)
    assert [n for n, _ in tr.device_ops()] == ["fold_kernel", "trace_kernel",
                                                "vectorized_elementwise_kernel", "Memcpy DtoD"]


def test_idle_gaps_by_host_operation():
    gaps = dict(devtrace.Trace(EVENTS).idle_gaps())
    # 100-110 and 195-200 under read.step alone, 150-170 under aten::cat,
    # 180-190 under read.step
    assert gaps["aten::cat"] == pytest.approx(20e-6)
    assert gaps["read.step"] == pytest.approx(25e-6)


def test_bare_name():
    assert devtrace.bare_name("void fold_kernel<2>(int const*)") == "fold_kernel"
    assert devtrace.bare_name(
        "void (anonymous namespace)::elementwise_kernel_with_index<int>(int)"
    ) == "elementwise_kernel_with_index"
