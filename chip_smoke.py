#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's encrypted read once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--reads N] [--profile] [--kernels-only]
                          [--verbose-build]

Phases (each prints one JSON line; any failure exits non-zero):

  device         the card (nvidia-smi name and power limit), torch and CUDA
  build          compiles the four CUDA kernels from fhe_ram_tpu_torch/csrc
  kernel checks  each kernel against its plain PyTorch version on the card,
                 at the shapes one read at PARAMS_2_18_TURBO_READOPT gives it
                 (torch.equal: integer arithmetic, tolerance 0), with times
  read           the port's own client from --seed: keygen, 2^18 x 4 random
                 bytes encrypted, then --reads reads at distinct addresses;
                 each decrypts to the plaintext word under the noise bound;
                 launch counters are set to 0 before and read after
  read_vs_plain  one of those reads again through the plain versions on the
                 card, bit-equal to the kernels' read
  kernels        one line for all kernels: launches on the read path, error,
                 time, the plain version's time, and the card's bound

The last line is {"ok": true, "device": {...}}.  Needs one CUDA device and
nvcc; imports fhe_ram_tpu_torch only.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Peak rates of one H100 SXM at its full 700 W limit (NVIDIA's data sheet):
# device memory, and 32-bit arithmetic outside the tensor cores.  The
# kernels' arithmetic is 32-bit integer work on those units; the float32
# rate is the data sheet's figure for them (the integer rate is no higher),
# so a bound taken from it is a floor.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps, warm, flush):
    """Median time of one call in ms, by CUDA events; the L2 cache is
    overwritten before every timed call, as the read path would leave it."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- the least time the card could take --------------------------------------
# Operations are counted in the ring Z_p: one modular multiply, add or
# subtract is one operation.  An n-point transform is (n/2) log2 n
# butterflies of 3 operations plus n twist multiplies; a fold's product is
# one multiply and one add per (digit poly, output poly, coefficient); the
# Garner step, the digit split and the carry are ~40 operations a
# reconstructed coefficient.

def ntt_ops(n):
    return 3 * (n // 2) * int(math.log2(n)) + n


def fold_ops(rows, T, M, n, P=3):
    return rows * (P * (T * ntt_ops(n) + M * (2 * T * n + ntt_ops(n))) + 40 * M * n)


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=8)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (a first look at new kernels)")
    ap.add_argument("--profile", action="store_true",
                    help="trace one more read with torch.profiler: device time "
                         "by kernel and the device's idle share")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print what ptxas says of each kernel (registers, spills)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs on the GPU only",
              file=sys.stderr)
        sys.exit(2)

    from fhe_ram_tpu_torch.params import PARAMS_2_18_TURBO_READOPT as PAR
    from fhe_ram_tpu_torch.ops import ntt_cuda
    from fhe_ram_tpu_torch.ops.ntt import get_ntt_context
    from fhe_ram_tpu_torch.core import glwe, keys as keys_mod, rng
    from fhe_ram_tpu_torch.ram import address as address_mod
    from fhe_ram_tpu_torch.ram import ram as ram_mod

    t_start = time.time()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- build -------------------------------------------------------------
    t0 = time.time()
    ntt_cuda.ensure_built(verbose=args.verbose_build)
    emit({"phase": "build", "ok": True, "seconds": round(time.time() - t0, 2),
          "sources": [f"fhe_ram_tpu_torch/csrc/{s}.cu" for s in ntt_cuda.SOURCES],
          "target": "sm_90a"})

    # ---- each kernel against its plain version, at the read's shapes -------
    n, P = PAR.n, PAR.num_primes
    W, R, C, L = PAR.word_size, PAR.num_rows, PAR.rank + 1, PAR.limbs_ct
    rank = PAR.rank
    Dk, Lkk = PAR.read_ks_trunc        # keyswitch: 2 digits, 3 key limbs
    De, Lge = PAR.read_ep_trunc        # external product: 2 digits, 3 limbs
    T_ep, M_ep = C * De, C * Lge       # 4, 6
    T_ks, M_ks = rank * Dk, C * Lkk    # 2, 6
    S = PAR.log_n
    ctx = get_ntt_context(n, PAR.primes)
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)  # 256 MB

    def limbs(shape, bits=16):
        return torch.randint(-(1 << bits), 1 << bits, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    def spectra(shape):
        """Prepared key rows: the transform of random normalized limbs."""
        return ntt_cuda.ntt_fwd_cuda(ctx, limbs(shape))

    checks = {}

    def check(name, shape_note, kernel_fn, reps=7, plain_reps=3):
        """Run kernel and plain version on the same tensors; compare; time."""
        got = kernel_fn()
        torch.cuda.synchronize()
        with ntt_cuda.plain_versions():
            want = kernel_fn()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name} {shape_note}: shape/dtype {got.shape} {got.dtype}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        ok = torch.equal(got, want)
        ms = time_ms(kernel_fn, reps, 2, flush)
        with ntt_cuda.plain_versions():
            plain_ms = time_ms(kernel_fn, plain_reps, 1, flush)
        rec = {"shape": shape_note, "ok": ok, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms}
        checks.setdefault(name, []).append(rec)
        if not ok:
            emit({"phase": "kernel_check", "name": name, **rec})
            fail(f"{name} {shape_note} disagrees with its plain version "
                 f"(max abs err {err})")
        return rec

    # kernel 1: both directions at B = 36 (one address coordinate's GGSW)
    x36 = limbs((36, n), bits=21)
    check("ntt_fwd", "x[36,4096]", lambda: ntt_cuda.ntt_fwd_cuda(ctx, x36))
    s36 = ntt_cuda.ntt_fwd_cuda(ctx, x36)
    check("ntt_inv", "x[3,36,4096]", lambda: ntt_cuda.ntt_inv_cuda(ctx, s36))

    # kernel 2: level 0 (B = W*R = 256) without and with base, level 1 (B = 4)
    keys_ep = spectra((1, T_ep, M_ep, n)).reshape(P, 1, T_ep, M_ep, n)
    x0 = limbs((W * R, T_ep, n))
    base0 = limbs((W * R, C, L, n), bits=17)
    check("fused_external_fold", f"x[{W*R},{T_ep},4096] keys[3,1,{T_ep},{M_ep},4096]",
          lambda: ntt_cuda.fused_external_fold(ctx, x0, keys_ep, L, C))
    check("fused_external_fold", f"x[{W*R},{T_ep},4096] with base, sign=-1",
          lambda: ntt_cuda.fused_external_fold(ctx, x0, keys_ep, L, C,
                                               base=base0, sign=-1))
    x1 = limbs((W, T_ep, n))
    check("fused_external_fold", f"x[{W},{T_ep},4096] (level 1)",
          lambda: ntt_cuda.fused_external_fold(ctx, x1, keys_ep, L, C))
    # two chained digits (T == C*L), a shape the narrow-digit presets use
    keys_ch = spectra((2, C * L, C * Lge, n)).reshape(P, 2, C * L, C * Lge, n)
    xch = limbs((W, C * L, n))
    check("fused_external_fold", f"x[{W},{C*L},4096] two chained digits",
          lambda: ntt_cuda.fused_external_fold(ctx, xch, keys_ch, L, C))

    # kernel 3: the 12-step trace of W = 4 rows
    gals = PAR.trace_gal_els
    keys_tr = spectra((S, T_ks, M_ks, n)).permute(1, 0, 2, 3, 4).contiguous()
    ct4 = limbs((W, C, L, n))
    check("fused_trace", f"ct[{W},{C},{L},4096] keys[{S},3,{T_ks},{M_ks},4096]",
          lambda: ntt_cuda.fused_trace(ctx, ct4, keys_tr, gals), plain_reps=2)

    # kernel 4: first (nb = 128, unnormalized inputs) and last (nb = 4) level
    key_pm = spectra((T_ks, M_ks, n))
    for nb, l in ((W * R // 2, 5), (W, 0)):
        A, Bc = limbs((nb, C, L, n), bits=17), limbs((nb, C, L, n), bits=17)
        t_rot, g = 1 << l, (n >> l) + 1
        check("fused_pack_merge", f"A,B[{nb},{C},{L},4096] t={t_rot} g={g}",
              lambda: ntt_cuda.fused_pack_merge(ctx, A, Bc, t_rot, g, key_pm))
    emit({"phase": "kernel_checks", "ok": True, "tolerance": 0, "checks": checks})
    if args.kernels_only:
        return

    # ---- the read, through the entry points a user calls -------------------
    ntt_cuda.reset_launches()
    t0 = time.time()
    src = rng.Source(args.seed)
    sk = rng.ternary_secret(src.split(), PAR.rank, n, PAR.xs_density, device=dev)
    s_ntt = glwe.secret_prepare(ctx, sk)
    ekp = keys_mod.prepare(PAR, keys_mod.keygen(PAR, sk, src))
    data = np.random.default_rng(args.seed).integers(
        0, 256, size=PAR.max_addr * W).astype(np.uint8)
    server = ram_mod.FheRam(PAR, ekp, device=dev)
    state = server.init_state(ram_mod.encrypt_ram(PAR, ctx, s_ntt, data, src))
    torch.cuda.synchronize()
    setup_s = time.time() - t0

    picks = np.random.default_rng(args.seed + 1).choice(
        np.arange(1, PAR.max_addr - 1), size=max(args.reads, 8) - 2, replace=False)
    addrs = [0, PAR.max_addr - 1] + [int(a) for a in picks]
    read_ms, worst_noise, per_read, outs = [], -1e9, None, {}
    for idx in addrs:
        ap_ = address_mod.prepare(ctx, address_mod.encrypt(PAR, ctx, s_ntt, idx, src))
        before = dict(ntt_cuda.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = server.read(state, ap_)
        torch.cuda.synchronize()
        read_ms.append((time.perf_counter() - t0) * 1e3)
        delta = {k: ntt_cuda.LAUNCHES[k] - before[k] for k in before}
        if per_read is None:
            per_read = delta
        want_delta = {"ntt_fwd": 0, "ntt_inv": 0, "fused_external_fold": 2,
                      "fused_trace": 1, "fused_pack_merge": 6}
        if delta != want_delta:
            fail(f"read at {idx}: launches {delta}, expected {want_delta}")
        if tuple(out.shape) != (W, C, L, n) or out.dtype != torch.int32:
            fail(f"read at {idx}: output {tuple(out.shape)} {out.dtype}")
        ph = glwe.phase(PAR, ctx, s_ntt, out)
        for i in range(W):
            want = glwe.cast_u8_signed(int(data[idx * W + i]), PAR.k_pt)
            val, noise = glwe.decode_coeff0(PAR, ph[i], want)
            if int(val) != want:
                fail(f"read at {idx}, byte {i}: decoded {int(val)}, stored {want}")
            if not noise < -(PAR.k_pt + 1):
                fail(f"read at {idx}, byte {i}: noise 2^{noise:.2f} over the bound")
            worst_noise = max(worst_noise, float(noise))
        outs[idx] = (ap_, out)
    path_launches = dict(ntt_cuda.LAUNCHES)
    for k, v in path_launches.items():
        if v == 0:
            fail(f"kernel {k} was not launched on the read path")
    emit({"phase": "read", "ok": True, "preset": "PARAMS_2_18_TURBO_READOPT",
          "max_addr": PAR.max_addr, "word_size": W, "n": n, "seed": args.seed,
          "reads": len(addrs), "addresses": addrs,
          "read_ms_median": statistics.median(read_ms), "read_ms": read_ms,
          "worst_noise_log2": worst_noise, "noise_bound_log2": -(PAR.k_pt + 1),
          "launches_per_read": per_read, "setup_seconds": round(setup_s, 2),
          "ram_ciphertext_bytes": state.data.numel() * 4})

    # ---- one read again through the plain versions, on the card ------------
    idx = addrs[-1]
    ap_, out = outs[idx]
    t0 = time.perf_counter()
    with ntt_cuda.plain_versions():
        plain_out = server.read(state, ap_)
    torch.cuda.synchronize()
    plain_read_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(plain_out, out):
        fail(f"read at {idx}: kernels and plain versions disagree")
    emit({"phase": "read_vs_plain", "ok": True, "address": idx,
          "plain_read_ms": plain_read_ms})

    # ---- optional: where one read's time goes -------------------------------
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            server.read(state, ap_)
            torch.cuda.synchronize()
            span_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.device_time_total / 1e3, e.count)
                for e in prof.key_averages() if e.device_time_total > 0
                and e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(r[1] for r in rows)
        rows.sort(key=lambda r: -r[1])
        # the profiler slows the host, so the idle share is taken against
        # the unprofiled median read time, not against the traced span
        emit({"phase": "profile", "read_span_ms_under_profiler": span_ms,
              "device_busy_ms": busy_ms if rows else None,
              "device_idle_share_of_read_ms_median":
                  1 - busy_ms / statistics.median(read_ms) if rows else None,
              "by_kernel": [{"name": k[:60], "ms": ms, "count": c}
                            for k, ms, c in rows[:12]]})

    # ---- the kernels' line --------------------------------------------------
    poly_b = 4 * n  # bytes of one int32 polynomial

    def entry(name, source, replaces, shape_idx, bytes_moved, ops):
        rec = checks[name][shape_idx]
        b_ms, b_by = bound(bytes_moved, ops)
        return {"name": name, "route": "cuda",
                "source": f"fhe_ram_tpu_torch/csrc/{source}",
                "replaces": f"fhe_ram_tpu/ops/ntt_pallas.py:{replaces}",
                "shape": rec["shape"], "launches": path_launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in checks[name]),
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    B0 = W * R
    nb0 = W * R // 2
    kernels = [
        entry("ntt_fwd", "ntt.cu", 454, 0,
              36 * poly_b * (1 + P), 36 * P * ntt_ops(n)),
        entry("ntt_inv", "ntt.cu", 499, 0,
              36 * poly_b * 2 * P, 36 * P * ntt_ops(n)),
        entry("fused_external_fold", "fold.cu", 1158, 0,
              poly_b * (B0 * T_ep + P * T_ep * M_ep + B0 * C * L),
              fold_ops(B0, T_ep, M_ep, n)),
        entry("fused_trace", "trace.cu", 1463, 0,
              poly_b * (2 * W * C * L + S * P * T_ks * M_ks),
              S * fold_ops(W, T_ks, M_ks, n)),
        entry("fused_pack_merge", "pack_merge.cu", 1582, 0,
              poly_b * (3 * nb0 * C * L + P * T_ks * M_ks),
              fold_ops(nb0, T_ks, M_ks, n)),
    ]
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": round(time.time() - t_start, 2)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
