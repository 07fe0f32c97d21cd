"""Multi-process dryrun of the port's dist path (parallel/dist.py): N
processes, each holding the same row-sharded RAM, form a global (dp = N,
rows = 2) mesh over torch.distributed; a batched read and a batched
read-modify-write run with the dp axis across the processes, on the fused
routes and again on the composed ones (composed=True, the counterpart of
the JAX package's FHERAM_MXU=0) in the same processes, and each process
decrypt-checks its own slices and holds the composed outputs equal to the
fused ones.

    python3 fhe_ram_tpu_torch/examples/multihost_dryrun.py               # 2 workers on the card
    python3 fhe_ram_tpu_torch/examples/multihost_dryrun.py --device cpu  # 2 workers on the CPU
    python3 fhe_ram_tpu_torch/examples/multihost_dryrun.py --nproc 4

On the card the workers run PARAMS_2_18_TURBO_READOPT (the CUDA kernels
take N = 4096 only; every worker makes the same keys and 2^18 x 4-byte RAM
from --seed, a few seconds each) and share it through gloo when there are
fewer cards than workers (default_backend); on the CPU, PARAMS_TEST_SMALL
with gloo and the plain versions.  Each worker reads 2 addresses a dp
replica, read-modify-writes 2 other ones with words from --seed, and reads
those back from the new RAM: every word decodes under the noise bound.  It
prints "multihost dryrun: OK" only when every worker passed.

A caller that holds the results against its own (tests/test_torch_dist.py,
chip_smoke.py's dist phase) writes the inputs with save_inputs and starts
the workers with run_workers(inputs=...): each worker then loads them onto
its device instead of making its own, runs the read and the RMW on both
routes, each once counted (launches and the shapes of the wrappers' calls)
and `reps` times timed (host clock after a barrier, synchronized), and
writes what it computed beside the inputs, out_<rank>.pt.  Workers import
the port only.
"""

import argparse
import contextlib
import functools
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as torch_dist  # noqa: E402

from fhe_ram_tpu_torch import params as params_mod  # noqa: E402
from fhe_ram_tpu_torch.convert import stack_addresses  # noqa: E402
from fhe_ram_tpu_torch.core import glwe, keys as keys_mod, rng  # noqa: E402
from fhe_ram_tpu_torch.ops import ntt_cuda  # noqa: E402
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context  # noqa: E402
from fhe_ram_tpu_torch.parallel import collective as coll_mod, dist  # noqa: E402
from fhe_ram_tpu_torch.ram import address as address_mod, ram as ram_mod  # noqa: E402

ROWS = 2            # rows shards a process: the pack's all-gather stays inside it
ADDRS_A_REPLICA = 2
MODULE = "fhe_ram_tpu_torch.examples.multihost_dryrun"
# the ntt_cuda wrappers the dist path calls (the all-gather is collective.py's)
PATH_WRAPPERS = ("ntt_fwd_cuda", "ntt_inv_cuda", "fused_external_fold",
                 "fused_external_fold_batched", "fused_trace", "fused_pack_merge",
                 "fused_split")


def preset_for(device: torch.device) -> str:
    return "PARAMS_2_18_TURBO_READOPT" if device.type == "cuda" else "PARAMS_TEST_SMALL"


# --------------------------------------------------------------------------
# the launcher's side
# --------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def save_inputs(path: str, preset: str, data, read_b, prep_b, coeff_b, w_b, keys):
    """Write CPU copies of one dist run's inputs for run_workers(inputs=):
    the RAM data [W, R, C, L, N], the prepared stacking of the full batch
    to read, the prepared and coefficient-domain stackings of the full
    batch to read-modify-write, its words [B, W, C, L, N] and the prepared
    keys."""
    def cpu(x):
        if torch.is_tensor(x):
            return x.cpu()
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        return tuple(cpu(v) for v in x)
    torch.save({"preset": preset, "data": cpu(data), "read_b": cpu(read_b),
                "prep_b": cpu(prep_b),
                "coeff_b": cpu(coeff_b), "w_b": cpu(w_b),
                "keys": {"atk_glwe": cpu(keys.atk_glwe), "atk_ggsw": cpu(keys.atk_ggsw),
                         "tsk": cpu(keys.tsk)}},
               os.path.join(path, "inputs.pt"))


def run_workers(nproc: int, device: str, inputs: str | None = None, seed: int = 0,
                reps: int = 3, timeout_s: float = 600.0) -> list:
    """Start nproc workers of this module, joined on tcp://localhost at a
    free port, and wait for all of them.  A worker that fails or hangs
    fails the run: the others are killed at once (they would wait in a
    collective), and all of them at timeout_s.  On the card the kernels are
    built here first, so that no two workers build at once.  Returns
    [(exit code, None if killed at the timeout), output] a worker."""
    if device == "cuda":
        ntt_cuda.ensure_built()
    port = free_port()
    env = {**os.environ, "PYTHONPATH": ROOT}
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    args = ["--device", device, "--nproc", str(nproc), "--port", str(port),
            "--seed", str(seed), "--reps", str(reps)]
    if inputs is not None:
        args += ["--inputs", inputs]
    with tempfile.TemporaryDirectory() as logs:
        files = [open(os.path.join(logs, f"{r}.log"), "w+") for r in range(nproc)]
        procs = [subprocess.Popen([sys.executable, "-m", MODULE, "--rank", str(r), *args],
                                  cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
                 for r, f in enumerate(files)]
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.poll() is None for p in procs):
                failed = any(p.poll() not in (None, 0) for p in procs)
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            timed_out = [p.poll() is None for p in procs]
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        out = []
        for p, f, hung in zip(procs, files, timed_out):
            f.seek(0)
            out.append((None if hung else p.returncode, f.read()))
            f.close()
    return out


# --------------------------------------------------------------------------
# the worker's side
# --------------------------------------------------------------------------

def call_note(name: str, args, kw) -> str:
    """The shape note of one wrapper call (its arguments after the
    context): tensor shapes, chunk lists as their count and shape, other
    arguments as written; the same for a worker and for a caller's run."""
    def one(a):
        if torch.is_tensor(a):
            return f"[{','.join(map(str, a.shape))}]"
        if isinstance(a, (list, tuple)) and a and torch.is_tensor(a[0]):
            return f"{len(a)}x{one(a[0])}"
        return repr(a)
    return " ".join([name] + [one(a) for a in args]
                    + [f"{k}={one(v)}" for k, v in sorted(kw.items())])


@contextlib.contextmanager
def recording_shapes(seen: dict):
    """Count in seen[note] every call of a wrapper on the dist path (the
    ntt_cuda wrappers of PATH_WRAPPERS, the all-gather) while the context
    is open."""
    real = {name: getattr(ntt_cuda, name) for name in PATH_WRAPPERS}
    real_gather = coll_mod.ring_all_gather

    def wrap(name, fn, skip):
        def call(*args, **kw):
            note = call_note(name, args[skip:], kw)
            seen[note] = seen.get(note, 0) + 1
            return fn(*args, **kw)
        return call
    for name, fn in real.items():
        setattr(ntt_cuda, name, wrap(name, fn, 1))
    coll_mod.ring_all_gather = wrap("ring_all_gather", real_gather, 0)
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(ntt_cuda, name, fn)
        coll_mod.ring_all_gather = real_gather


def tensors(x) -> list:
    """The tensors of a nested list / tuple, in order."""
    if torch.is_tensor(x):
        return [x]
    return [t for v in x for t in tensors(v)]


def to_cpu(x):
    if torch.is_tensor(x):
        return x.cpu()
    return [to_cpu(v) for v in x]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _client(par, dev, seed: int, batch: int):
    """What every worker of the dryrun makes alike from the seed: keys, the
    RAM, `batch` addresses to read and `batch` other ones to read-modify-write
    with words; and the check that a word decodes."""
    ctx = get_ntt_context(par.n, par.primes)
    src = rng.Source(seed)
    sk = rng.ternary_secret(src.split(), par.rank, par.n, par.xs_density, device=dev)
    s_ntt = glwe.secret_prepare(ctx, sk)
    keys = keys_mod.prepare(par, keys_mod.keygen(par, sk, src))
    rnd = np.random.default_rng(seed)
    plain = rnd.integers(0, 256, size=par.max_addr * par.word_size).astype(np.uint8)
    data = ram_mod.encrypt_ram(par, ctx, s_ntt, plain, src)
    idxs = [int(i) for i in rnd.choice(par.max_addr, size=2 * batch, replace=False)]
    coeff = [address_mod.encrypt(par, ctx, s_ntt, i, src) for i in idxs]
    prep = stack_addresses([address_mod.prepare(ctx, a) for a in coeff])
    coeff = stack_addresses(coeff)
    words = rnd.integers(0, 256, size=(batch, par.word_size)).astype(np.uint8)
    w_b = torch.stack([ram_mod.encrypt_write_word(par, ctx, s_ntt, w, src)
                       for w in words])

    def decodes(out, idx, plain_):
        for i in range(par.word_size):
            want = glwe.cast_u8_signed(int(plain_[idx * par.word_size + i]), par.k_pt)
            val, noise = glwe.decode_coeff0(par, glwe.phase(par, ctx, s_ntt, out[i]), want)
            if int(val) != want or not noise < -(par.k_pt + 1):
                return False
        return True
    inputs = {"data": data, "read_b": tuple(c[:batch] for c in prep),
              "prep_b": tuple(c[batch:] for c in prep),
              "coeff_b": tuple(c[batch:] for c in coeff), "w_b": w_b, "keys": keys}
    return inputs, idxs, plain, words, decodes


def worker(rank: int, nproc: int, port: int, device: str, inputs: str | None,
           seed: int, reps: int) -> int:
    dist.init_distributed(f"tcp://localhost:{port}", nproc, rank,
                          backend="gloo" if device == "cpu" else None, timeout_s=120)
    dev = dist.process_device() if device == "cuda" else torch.device("cpu")
    if dev.type == "cpu":
        torch.set_num_threads(1)
    elif dev.index is not None:
        torch.cuda.set_device(dev)
    mesh = dist.make_multihost_mesh(ROWS, device=dev)
    if inputs is not None:
        got = torch.load(os.path.join(inputs, "inputs.pt"))
        par = getattr(params_mod, got["preset"])
        got["keys"] = keys_mod.EvaluationKeysPrepared(**got["keys"])
    else:
        par = getattr(params_mod, preset_for(dev))
        got, idxs, plain, words, decodes = _client(par, dev, seed,
                                                   mesh.dp * ADDRS_A_REPLICA)
    shards = dist.shard_rows_global(mesh, got["data"])
    keys = dist.replicated_global(mesh, got["keys"])
    read_l, prep_l, coeff_l, w_l = (dist.host_local_batch(mesh, got[k])
                                    for k in ("read_b", "prep_b", "coeff_b", "w_b"))
    calls = {}
    for route, composed in (("", False), ("composed_", True)):
        read_fn = dist.batched_read_fn(par, mesh, composed=composed)
        rmw_fn = dist.batched_rmw_fn(par, mesh, composed=composed)
        calls[f"{route}read"] = functools.partial(read_fn, shards, read_l, keys.atk_glwe)
        calls[f"{route}rmw_batch"] = functools.partial(rmw_fn, shards, prep_l, coeff_l,
                                                       w_l, keys)

    result = {"rank": rank, "mesh": mesh.shape, "backend": torch_dist.get_backend(),
              "launches": {}, "shapes": {}, "ms": {}, "outputs": {}}
    for name, fn in calls.items():
        ntt_cuda.reset_launches()
        with recording_shapes(result["shapes"].setdefault(name, {})):
            out = fn()
            _sync(dev)
        result["launches"][name] = {k: v for k, v in ntt_cuda.LAUNCHES.items() if v}
        result["outputs"][name] = out
        result["ms"][name] = []
        for _ in range(reps):
            torch_dist.barrier()
            _sync(dev)
            t0 = time.perf_counter()
            again = fn()
            _sync(dev)
            result["ms"][name].append((time.perf_counter() - t0) * 1e3)
            if not all(torch.equal(a, b) for a, b in zip(tensors(again), tensors(out))):
                raise RuntimeError(f"{name}: a timed call differs from the first")
    outputs = result.pop("outputs")
    reads, (rmw_outs, new) = outputs["read"], outputs["rmw_batch"]
    c_reads, (c_rmw_outs, c_new) = outputs["composed_read"], outputs["composed_rmw_batch"]
    # the RMW's cross-process step alone: one int32 all_reduce a rows shard
    # of the new shards' size, timed as the paths are
    result["ms"]["all_reduce"] = []
    for _ in range(reps):
        sums = [s.clone() for s in new]
        torch_dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        for s in sums:
            torch_dist.all_reduce(s)
        _sync(dev)
        result["ms"]["all_reduce"].append((time.perf_counter() - t0) * 1e3)
    if inputs is not None:
        # the cross-process sum wraps as int32, as the reference's psum does
        probe = torch.tensor([2 ** 31 - 1 if rank == 0 else 1], dtype=torch.int32,
                             device=dev)
        torch_dist.all_reduce(probe)
        result.update(read=to_cpu(reads), rmw_outs=to_cpu(rmw_outs), new=to_cpu(new),
                      composed_read=to_cpu(c_reads), composed_rmw_outs=to_cpu(c_rmw_outs),
                      composed_new=to_cpu(c_new),
                      int32_sum_wraps=probe.item() == nproc - 2 - 2 ** 31,
                      foreign_modules=sorted(m for m in sys.modules
                                             if m.split(".")[0] in ("jax", "fhe_ram_tpu")))
        torch.save(result, os.path.join(inputs, f"out_{rank}.pt"))
        torch_dist.destroy_process_group()
        return 0
    # the dryrun: this process's slices decode on every rows shard, and the
    # new words read back from the new RAM
    B = got["w_b"].shape[0]
    plain_new = plain.copy()
    for k, w in enumerate(words):
        plain_new[idxs[B + k] * par.word_size: (idxs[B + k] + 1) * par.word_size] = w
    back = dist.batched_read_fn(par, mesh)(new, prep_l, keys.atk_glwe)
    composed_equal = all(
        torch.equal(a, b) for a, b in zip(tensors((c_reads, c_rmw_outs, c_new)),
                                          tensors((reads, rmw_outs, new))))
    ok = composed_equal
    b = B // nproc
    for j, g in enumerate(range(rank * b, (rank + 1) * b)):
        for k in range(ROWS):
            ok &= decodes(reads[0][k][j], idxs[g], plain)
            ok &= decodes(rmw_outs[0][k][j], idxs[B + g], plain)
            ok &= decodes(back[0][k][j], idxs[B + g], plain_new)
    print(f"[process {rank}] mesh={mesh.shape} device={dev} preset={preset_for(dev)} "
          f"batch={B} read_ms={result['ms']['read']} "
          f"rmw_batch_ms={result['ms']['rmw_batch']} "
          f"composed_read_ms={result['ms']['composed_read']} "
          f"composed_rmw_batch_ms={result['ms']['composed_rmw_batch']} "
          f"composed {'==' if composed_equal else '!='} fused "
          f"{'ALL CORRECT' if ok else 'WRONG'}", flush=True)
    torch_dist.destroy_process_group()
    return 0 if ok else 1


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default; the card, shared through gloo when "
                         "the workers outnumber the cards) or cpu (gloo)")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        sys.exit(worker(args.rank, args.nproc, args.port, args.device, args.inputs,
                        args.seed, args.reps))
    results = run_workers(args.nproc, args.device, seed=args.seed, reps=args.reps)
    ok = True
    for rank, (rc, log) in enumerate(results):
        print(log, end="", flush=True)
        if rc != 0:
            print(f"[process {rank}] {'hung: killed' if rc is None else f'exit {rc}'}",
                  flush=True)
            ok = False
    print("multihost dryrun:", "OK" if ok else "FAILED", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
