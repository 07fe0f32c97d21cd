"""The PyTorch port's multi-process mesh (parallel/dist.py) on the CPU.

* Two gloo processes (fhe_ram_tpu_torch/examples/multihost_dryrun.py's
  workers, which import the port only, under a timeout) form a global dp 2
  x rows 2 mesh at PARAMS_TEST_SMALL and run the dist batched read and the
  dist batched read-modify-write on the inputs this process wrote, on the
  fused routes and, in the same processes, on the composed ones
  (composed=True).  Their read-outs and both processes' whole new RAM equal
  the single-process batched_read_fn / batched_rmw_fn on a dp 2 x rows 2
  mesh bit for bit, the composed ones also the single-process composed
  mesh's; every shape a worker called a wrapper at is one the
  single-process run of its route called it at.  (The single-process paths are held against the JAX package
  in tests/test_torch_parallel.py and tests/test_torch_read.py.)
* In this process, a one-process gloo group: init_distributed is
  idempotent, the backend choice, the global mesh's shape, the refusals.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch
import torch.distributed as torch_dist

from fhe_ram_tpu_torch import params as tparams
from fhe_ram_tpu_torch.convert import stack_addresses
from fhe_ram_tpu_torch.core import glwe, keys as keys_mod, rng
from fhe_ram_tpu_torch.examples import multihost_dryrun as dryrun
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context
from fhe_ram_tpu_torch.parallel import dist
from fhe_ram_tpu_torch.parallel import mesh as tmesh
from fhe_ram_tpu_torch.ram import address as address_mod
from fhe_ram_tpu_torch.ram import ram as ram_mod

torch.set_num_threads(1)

PAR = tparams.PARAMS_TEST_SMALL


def test_dist_paths_equal_the_single_process_mesh(tmp_path):
    ctx = get_ntt_context(PAR.n, PAR.primes)
    src = rng.Source(15)
    sk = rng.ternary_secret(src.split(), PAR.rank, PAR.n, PAR.xs_density, device="cpu")
    s_ntt = glwe.secret_prepare(ctx, sk)
    keys = keys_mod.prepare(PAR, keys_mod.keygen(PAR, sk, src))
    plain = np.random.default_rng(16).integers(
        0, 256, size=PAR.max_addr * PAR.word_size).astype(np.uint8)
    data = ram_mod.encrypt_ram(PAR, ctx, s_ntt, plain, src)
    coeff = [address_mod.encrypt(PAR, ctx, s_ntt, i, src) for i in (5, 60, 131, 254,
                                                                    7, 100, 200, 33)]
    prep = stack_addresses([address_mod.prepare(ctx, a) for a in coeff])
    coeff = stack_addresses(coeff)
    read_b = tuple(c[:4] for c in prep)
    prep_b, coeff_b = tuple(c[4:] for c in prep), tuple(c[4:] for c in coeff)
    w_b = torch.stack([ram_mod.encrypt_write_word(PAR, ctx, s_ntt, [i, 250 - i], src)
                       for i in range(4)])
    dryrun.save_inputs(str(tmp_path), "PARAMS_TEST_SMALL", data, read_b, prep_b,
                       coeff_b, w_b, keys)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        workers = pool.submit(dryrun.run_workers, 2, "cpu", inputs=str(tmp_path),
                              reps=0, timeout_s=240)
        # the single-process mesh of the same global shape, meanwhile
        mesh = tmesh.make_mesh(4, rows=2, devices=["cpu"] * 4)
        shards = tmesh.shard_data_rows(mesh, data)
        want, seen = {}, {}
        for route, composed in (("", False), ("composed_", True)):
            with dryrun.recording_shapes(seen.setdefault(route, {})):
                want[route] = (
                    tmesh.batched_read_fn(PAR, mesh, composed=composed)(
                        shards, tmesh.shard_addr_batch(mesh, read_b), keys.atk_glwe),
                    *tmesh.batched_rmw_fn(PAR, mesh, composed=composed)(
                        shards, tmesh.shard_addr_batch(mesh, prep_b),
                        tmesh.shard_addr_batch(mesh, coeff_b),
                        tmesh.shard_addr_batch(mesh, w_b), keys))
        results = workers.result()
    assert [rc for rc, _ in results] == [0, 0], [log[-3000:] for _, log in results]

    want_read, want_outs, want_new = want[""]
    want_new = tmesh.unshard_rows(want_new)
    assert not torch.equal(want_new, data)
    c_read, c_outs, c_new = want["composed_"]
    assert torch.equal(tmesh.unshard_rows(c_new), want_new)
    for rank in range(2):
        got = torch.load(os.path.join(tmp_path, f"out_{rank}.pt"))
        assert got["mesh"] == {"dp": 2, "rows": 2} and got["foreign_modules"] == []
        assert got["int32_sum_wraps"]
        for route, (reads, outs) in (("", (want_read, want_outs)),
                                     ("composed_", (c_read, c_outs))):
            for k in range(2):                   # every rows shard's copy
                assert torch.equal(got[f"{route}read"][0][k], reads[rank][k])
                assert torch.equal(got[f"{route}read"][0][k], want_read[rank][k])
                assert torch.equal(got[f"{route}rmw_outs"][0][k], outs[rank][k])
                assert torch.equal(got[f"{route}rmw_outs"][0][k], want_outs[rank][k])
            assert torch.equal(tmesh.unshard_rows(got[f"{route}new"]), want_new)
            for path in ("read", "rmw_batch"):
                assert set(got["shapes"][route + path]) <= set(seen[route]), route + path
            assert got["shapes"][route + "rmw_batch"], "no wrapper was called"


def test_init_backend_mesh_and_refusals(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="init_distributed"):
        dist.make_multihost_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        dist.init_distributed(f"tcp://localhost:{dryrun.free_port()}", rank=0,
                              backend="gloo")
    # nccl only where every local rank can have a card of its own
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dist.default_backend(1) == "nccl" and dist.default_backend(2) == "gloo"
    monkeypatch.undo()
    assert dist.default_backend(1) == ("nccl" if torch.cuda.is_available() else "gloo")

    dist.init_distributed(f"tcp://localhost:{dryrun.free_port()}", 1, 0, backend="gloo",
                          timeout_s=60)
    try:
        group = torch_dist.group.WORLD
        dist.init_distributed("tcp://localhost:1", 1, 0)    # formed: returns at once
        assert torch_dist.group.WORLD is group
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                dist.make_multihost_mesh(2)              # the card by default
        mesh = dist.make_multihost_mesh(2, device="cpu")
        assert mesh.shape == {"dp": 1, "rows": 2} and mesh.local.shape == mesh.shape
        assert (mesh.rank, mesh.world, mesh.group) == (0, 1, group)
        # rank 1 of 3 processes, each a dp 2 x rows 2 mesh: global dp 6
        mid = dist.MultihostMesh(local=tmesh.make_mesh(4, rows=2, devices=["cpu"] * 4),
                                 rank=1, world=3, group=group)
        x = torch.arange(12 * 3, dtype=torch.int32).reshape(12, 3)
        assert [s.tolist() for s in dist.host_local_batch(mid, x)] == [
            x[4:6].tolist(), x[6:8].tolist()]
        with pytest.raises(ValueError):              # 8 items over dp 6
            dist.host_local_batch(mid, x[:8])
        data = torch.arange(8, dtype=torch.int32).reshape(1, 8, 1)
        assert torch.equal(tmesh.unshard_rows(dist.shard_rows_global(mesh, data)), data)
        t = torch.ones(2, dtype=torch.int32)
        assert dist.replicated_global(mesh, t) is t     # on its device already
    finally:
        torch_dist.destroy_process_group()
