"""One run of one cell: set-up, an optional traced stretch, the measured
window, the check against the plain reference, the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file found by its name: `configs/<config>.json`,
`workloads/<cell>.json`, `traffic/<kind>.py` and
`layer_metrics/<metric>.py` (or `<family>.py` for `<family>.<suffix>`).
`Layout` looks in the directories it is given first, then in this folder.

Set-up makes every input from the seed: the secret key, the RAM's bytes,
the addresses and the words on the device with a torch.Generator; the
port's client (`fhe_ram_tpu_torch`: keygen, RAM, address and word
encryption) encrypts them, and the reference (`reference/`) is handed the
same secret, bytes, addresses and words.  From the program the benchmark
takes the server under test (`FheRam`), its launch counters
(`ops.ntt_cuda.LAUNCHES`) and its kernel names.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from benchmark import devtrace, stats
from benchmark.reference import ram_reference as ref

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fhe_ram_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)


def load_module(path: Path):
    name = "bench_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Layout:
    """Where the data and code files of configurations, cells, traffic
    kinds and per-layer metrics are found, by name."""

    def __init__(self, *roots):
        self.roots = [Path(r) for r in roots] + [BENCH_DIR]

    def find(self, sub: str, stem: str, suffix: str) -> Path | None:
        for r in self.roots:
            p = r / sub / f"{stem}{suffix}"
            if p.is_file():
                return p
        return None

    def _need(self, sub, stem, suffix):
        p = self.find(sub, stem, suffix)
        if p is None:
            raise FileNotFoundError(f"no {sub}/{stem}{suffix}")
        return p

    def config(self, name: str) -> dict:
        return json.loads(self._need("configs", name, ".json").read_text())

    def workload(self, name: str) -> dict:
        return json.loads(self._need("workloads", name, ".json").read_text())

    def traffic(self, kind: str):
        return load_module(self._need("traffic", kind, ".py"))

    def layer_metric(self, name: str):
        p = self.find("layer_metrics", name, ".py") or \
            self.find("layer_metrics", name.split(".")[0], ".py")
        if p is None:
            raise FileNotFoundError(f"no layer_metrics/ file for {name}")
        return load_module(p)


def cell_metrics(bench: dict, cell: str):
    """The cell's end-to-end metrics and per-layer metrics, as
    BENCHMARK.json assigns them."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", ()) or
             ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


class Reservoir:
    """A uniform sample of at most k of the steps offered, drawn from the
    seed (reservoir sampling).  A step's answer (meta, tensor) is copied
    into a buffer made at the first offer (in set-up), so keeping answers
    allocates nothing in the window."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.slots, self.buf = int(k), 0, [], None
        self._rng = random.Random(seed)

    def offer(self, i, item):
        meta, t = item
        self.n += 1
        if len(self.slots) < self.k:
            slot = len(self.slots)
            self.slots.append(None)
        else:
            slot = self._rng.randrange(self.n)
            if slot >= self.k:
                return
        if self.buf is None:
            self.buf = t.new_empty((self.k,) + tuple(t.shape))
        self.buf[slot].copy_(t)
        self.slots[slot] = (i, meta)

    def kept(self):
        """(steps, metas, answers on the host), in slot order."""
        steps = [i for i, _ in self.slots]
        metas = [m for _, m in self.slots]
        return steps, metas, self.buf[: len(self.slots)].cpu().numpy()


def ternary_secret(gen, rank: int, n: int, density: float, device):
    """A sparse ternary secret with exact weight round(density n), balanced
    signs, from the generator on the device: int32[rank, n]."""
    import torch

    nz = int(round(n * density))
    template = torch.zeros(n, dtype=torch.int32, device=device)
    template[: nz // 2] = 1
    template[nz // 2: nz] = -1
    perm = torch.argsort(torch.rand((rank, n), generator=gen, device=device), dim=-1)
    return template[perm]


class Run:
    """The state of one run: configuration, the port's client and server,
    the inputs made from the seed."""

    def __init__(self, layout: Layout, cell_name: str, seed: int, device):
        import torch

        from fhe_ram_tpu_torch.params import Params

        self.torch = torch
        self.layout = layout
        self.cell_name = cell_name
        self.cell = layout.workload(cell_name)
        self.cfg = layout.config(self.cell["config"])
        self.kind = layout.traffic(self.cell["kind"])
        self.tp = self.cell.get("params", {})
        self.params = Params(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in self.cfg["params"].items()})
        self.seed = int(seed)
        self.device = torch.device(device)
        self.is_cuda = self.device.type == "cuda"
        if self.is_cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seed % (1 << 63))
        self.np_rng = np.random.default_rng(self.seed % (1 << 63))

    def sync(self):
        if self.is_cuda:
            self.torch.cuda.synchronize(self.device)

    def setup_client(self):
        """Keys, RAM and server from the seed (the port's client)."""
        torch = self.torch
        from fhe_ram_tpu_torch.core import glwe, keys as keys_mod, rng
        from fhe_ram_tpu_torch.ops.ntt import get_ntt_context
        from fhe_ram_tpu_torch.ram import ram as ram_mod

        p = self.params
        self.sk = ternary_secret(self.gen, p.rank, p.n, p.xs_density, self.device)
        self.ctx = get_ntt_context(p.n, p.primes)
        self.s_ntt = glwe.secret_prepare(self.ctx, self.sk)
        self.source = rng.Source(self.seed % (1 << 127))
        self.keys = keys_mod.prepare(p, keys_mod.keygen(p, self.sk, self.source))
        self.ram_bytes = torch.randint(
            0, 256, (p.max_addr * p.word_size,), generator=self.gen,
            device=self.device, dtype=torch.int32).to(torch.uint8).cpu().numpy()
        opts = self.cfg.get("server", {})
        self.server = ram_mod.FheRam(p, self.keys, device=self.device,
                                     tree_kernels=bool(opts.get("tree_kernels", False)),
                                     composed=bool(opts.get("composed", False)))
        self.state = self.server.init_state(ram_mod.encrypt_ram(
            p, self.ctx, self.s_ntt, self.ram_bytes, self.source))

    def distinct_addresses(self, k: int):
        """k distinct addresses, uniform over the RAM, from the seed."""
        torch = self.torch
        perm = torch.randperm(self.params.max_addr, generator=self.gen, device=self.device)
        return perm[:k].cpu().numpy().astype(np.int64)

    def random_words(self, k: int):
        torch = self.torch
        return torch.randint(0, 256, (k, self.params.word_size), generator=self.gen,
                             device=self.device, dtype=torch.int32).to(
                                 torch.uint8).cpu().numpy()


def _step(run, ks, i, record_function=None):
    if record_function is None:
        return run.kind.step(run, ks, i)
    with record_function(f"{run.cell['kind']}.step"):
        return run.kind.step(run, ks, i)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_start: float, bench: dict, device="cuda", layout: Layout | None = None,
             log=None):
    """One run; returns the result dict (the last line the command prints)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    layout = layout or Layout()
    run = Run(layout, cell_name, seed, device)
    e2e, layer = cell_metrics(bench, cell_name)
    from fhe_ram_tpu_torch.ops import ntt_cuda

    if run.is_cuda:
        torch.cuda.set_device(run.device)
        ntt_cuda.ensure_built()

    t_client = time.time()
    run.setup_client()
    kind, tp = run.kind, run.tp
    t_pool = time.time()
    ks = kind.setup(run, tp)
    t_warm = time.time()
    keep = Reservoir(int(tp.get("keep", 1024)), run.seed ^ 0x5EED)
    i = 0
    for _ in range(int(tp.get("warmup", 2))):
        keep.offer(i, _step(run, ks, i))
        i += 1
    run.sync()
    log(f"set-up: start to client {t_client - t_start:.2f} s, keys and RAM "
        f"{t_pool - t_client:.2f} s, the traffic's pools {t_warm - t_pool:.2f} s, "
        f"warm-up {time.time() - t_warm:.2f} s")

    reading, breakdown, dev_extra = None, None, {}
    if trace:
        from torch.profiler import record_function

        steps = int(tp.get("trace_steps", 8))
        before = sum(ntt_cuda.LAUNCHES.values())
        with devtrace.profiled(run.is_cuda, run.sync) as held:
            for _ in range(steps):
                keep.offer(i, _step(run, ks, i, record_function))
                i += 1
        tr = held.trace
        reading = SimpleNamespace(
            trace=tr, steps=steps, launches=sum(ntt_cuda.LAUNCHES.values()) - before,
            params=run.cfg["params"], op=kind.ROOFLINE_OP, batch=kind.batch(tp),
            is_cuda=run.is_cuda)
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
        dev_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        log(f"trace: {steps} steps, {reading.launches} launches counted, "
            f"{tr.port_launches()} port kernels in the trace, busy {tr.busy_s:.6f} s "
            f"of {tr.window_s:.6f} s")

    gc.collect()
    t_first = time.time()
    setup_s = t_first - t_start
    lat, steps_done = [], 0
    t_begin = time.perf_counter()
    deadline = t_begin + float(seconds)
    while True:
        t0 = time.perf_counter()
        ans = kind.step(run, ks, i)
        run.sync()
        t1 = time.perf_counter()
        lat.append((t1 - t0) * 1e3)
        keep.offer(i, ans)
        i += 1
        steps_done += 1
        if t1 >= deadline:
            break
    window_s = time.perf_counter() - t_begin
    peak = int(torch.cuda.max_memory_allocated(run.device)) if run.is_cuda else 0

    per_step = kind.addresses_per_step(tp)
    attempted = steps_done * per_step
    latencies = {kind.LATENCY_OP: lat}
    counts = {kind.COUNT_OP: attempted}

    # ---- the check: after the window, the program's state freed ----------
    judged = kind.collect(run, ks, *keep.kept())   # host copies of what is judged
    keep = None
    run.server = run.state = run.keys = None
    ks = None
    gc.collect()
    if run.is_cuda:
        torch.cuda.empty_cache()
    t_check = time.time()
    sk = run.sk.cpu().numpy()
    wrong = failed = checked = 0
    noise = 0.0
    for what, cts, want in judged:
        judge = ref.judge_answers if what == "answers" else ref.judge_ram
        w, f, s = judge(cts, want, sk, run.params.k_pt)
        checked += cts.shape[0] if what == "answers" else want.shape[0]
        wrong, failed, noise = wrong + w, failed + f, max(noise, s)
    log(f"check: {checked} answers judged by the reference in {time.time() - t_check:.2f} s")
    limit = float(run.cell["limits"]["noise_share"])
    checks = {
        "wrong_bytes": {"value": wrong, "limit": 0},
        "noise_share": {"value": noise, "limit": limit},
        "answers_checked": {"value": checked, "limit": 1},
    }
    ok = wrong == 0 and noise <= limit and checked >= 1
    if reading is not None:
        lost = abs(reading.trace.port_launches() - reading.launches) if run.is_cuda else 0
        checks["lost_kernels"] = {"value": lost, "limit": 0}
        ok = ok and lost == 0

    metrics = {}
    if trace:
        for m in layer:
            v = layout.layer_metric(m["name"]).read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in e2e:
            v = setup_s if m["name"] == "setup_s" else stats.end_to_end(
                m["name"], latencies, counts, window_s)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    device_info = {"platform": "gpu" if run.is_cuda else "cpu",
                   "kind": torch.cuda.get_device_name(run.device) if run.is_cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak, **dev_extra}
    result = {"correct": bool(ok), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["window"] = {"seconds": window_s, "steps": steps_done,
                        "setup_s": setup_s}
    result["checks"] = checks
    return result


def check_lines(checks: dict):
    """One plain line a compared number: name, value, limit, verdict."""
    out = []
    for name, c in checks.items():
        rel = ">=" if name == "answers_checked" else "<="
        good = c["value"] >= c["limit"] if rel == ">=" else c["value"] <= c["limit"]
        out.append(f"check {name} {c['value']!r} {rel} {c['limit']!r} "
                   f"{'ok' if good else 'FAILED'}")
    return out
