"""Multi-process meshes on torch.distributed: the (dp, rows) mesh with its
dp axis spread over processes.

Counterpart of fhe_ram_tpu/parallel/dist.py.  The reference spans hosts
with jax.distributed and one global GSPMD mesh.  Here every process keeps
the single-controller Mesh of parallel/mesh.py over its own device, shaped
(dp_local, rows), and the global mesh is (world * dp_local, rows):

  * rows never crosses a process: the pack's collective (kernel 13 or 14)
    stays inside one, the reference's "rows inside a host, dp across
    hosts";
  * dp spans processes: each process serves its own dp slices of a batch
    that every process holds, so the batched read needs nothing from
    another process and returns this process's slices only (gathering them
    is the caller's business);
  * the batched read-modify-write adds the dp replicas' delta sums across
    processes, the reference's lax.psum over dp: one int32
    all_reduce(SUM) of each rows shard's total, in place, before
    normalize(data + upd).  That psum is XLA's, not a Pallas kernel, so a
    library collective stands in for it.  Integer sums commute and int32
    wraps in both, so every process's new RAM equals the single-process
    batched_rmw_fn's on a mesh of the same global shape, bit for bit.

Every process holds the same RAM shards and keys; the RMW's new shards come
out equal on every process.

Backends: gloo on the CPU and wherever ranks share a card (gloo carries
CUDA tensors through host memory; NCCL refuses two ranks on one GPU, and a
machine with one H100 runs its ranks that way), nccl where each rank has a
card of its own.  The nccl branch has not been run: no machine with
several cards was at hand.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as torch_dist

from ..params import Params
from ..ops import limb as limb_ops
from ..ops.ntt_cuda import require_device
from . import mesh as mesh_mod


def default_backend(local_world_size: int) -> str:
    """nccl when every one of the local_world_size ranks of this machine
    can have a card of its own, else gloo (the CPU, or ranks that share a
    card)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise ValueError(f"{name} is not set: pass it, or start the process "
                         "with torchrun")
    return int(value)


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, backend: str | None = None,
                     timeout_s: float = 300.0):
    """Form the default process group; a second call, with the group
    formed, returns at once.

    Arguments left None come from torchrun's environment: init_method
    "env://" (MASTER_ADDR, MASTER_PORT), WORLD_SIZE, RANK.  Elsewhere pass
    them, e.g. init_method="tcp://localhost:29517".  backend None: nccl
    when each of this machine's ranks (LOCAL_WORLD_SIZE, else world_size)
    has a card of its own, gloo otherwise (default_backend).  A group that
    does not form within timeout_s raises; nothing falls back to another
    backend or to fewer processes."""
    if torch_dist.is_initialized():
        return
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    rank = _env_int("RANK") if rank is None else rank
    if backend is None:
        backend = default_backend(int(os.environ.get("LOCAL_WORLD_SIZE", world_size)))
    torch_dist.init_process_group(backend, init_method=init_method or "env://",
                                  world_size=world_size, rank=rank,
                                  timeout=datetime.timedelta(seconds=timeout_s))


def process_device() -> torch.device:
    """This process's card: its own (LOCAL_RANK, else the rank modulo the
    cards) under nccl, the card the ranks share under any other backend.
    Raises without a card (pass device="cpu" to make_multihost_mesh)."""
    if torch_dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK", torch_dist.get_rank()))
        return require_device(f"cuda:{local % torch.cuda.device_count()}")
    return require_device("cuda")


@dataclass(frozen=True)
class MultihostMesh:
    """The global (dp, rows) mesh of one process: `local`, its own
    (dp_local, rows) Mesh over its device; global dp index rank * dp_local
    + j is local dp index j."""

    local: mesh_mod.Mesh
    rank: int
    world: int
    group: object

    @property
    def dp(self) -> int:
        return self.world * self.local.dp

    @property
    def rows(self) -> int:
        return self.local.rows

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "rows": self.rows}


def make_multihost_mesh(rows_per_process: int | None = None,
                        device=None) -> MultihostMesh:
    """The global (dp, rows) mesh over the processes of the default group:
    rows = rows_per_process (default 1: one device a process, as the
    reference's default takes every local device), dp = world, one dp
    index a process.  device: this process's device (default
    process_device())."""
    if not torch_dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    rows = rows_per_process or 1
    dev = process_device() if device is None else require_device(device)
    local = mesh_mod.make_mesh(rows, rows=rows, devices=[dev] * rows)
    return MultihostMesh(local=local, rank=torch_dist.get_rank(),
                         world=torch_dist.get_world_size(),
                         group=torch_dist.group.WORLD)


def host_local_batch(mesh: MultihostMesh, batch) -> list:
    """This process's dp slices of a FULL stacked batch that every process
    holds (a tuple of [B, ...] tensors, or one such tensor), as
    mesh.shard_addr_batch lists them: B / dp items a slice, on the
    process's device."""
    parts = batch if isinstance(batch, tuple) else (batch,)
    B = parts[0].shape[0]
    if B % mesh.dp:
        raise ValueError(f"a batch of {B} over {mesh.dp} dp replicas")
    b = B // mesh.world
    mine = tuple(p[mesh.rank * b: (mesh.rank + 1) * b] for p in parts)
    return mesh_mod.shard_addr_batch(mesh.local, mine if isinstance(batch, tuple)
                                     else mine[0])


def replicated_global(mesh: MultihostMesh, x):
    """x (a tensor, or a dict / tuple / list / dataclass of them) on this
    process's device, shared as mesh.replicated shares it."""
    return mesh_mod.replicated(mesh.local, x)


def shard_rows_global(mesh: MultihostMesh, data) -> list:
    """RAM data [W, R, C, L, N] as this process's row shards, strided as
    mesh.shard_data_rows makes them (rows are replicated over dp, so every
    process holds all of them)."""
    return mesh_mod.shard_data_rows(mesh.local, data)


def batched_read_fn(params: Params, mesh: MultihostMesh, with_cache: bool = False,
                    collective: str = "ring", batch_slice: int = 64,
                    composed: bool = False):
    """mesh.batched_read_fn on this process's part of the global mesh: call
    as fn(data, coords_b, atk[, cache]) with data from shard_rows_global and
    coords_b from host_local_batch; returns this process's dp slices'
    reads, a list over its dp_local slices of lists over rows shards of
    [B / dp, W, C, L, N].  No step crosses processes.  composed: the
    composed routes, as the mesh factories take them."""
    return mesh_mod.batched_read_fn(params, mesh.local, with_cache=with_cache,
                                    collective=collective, batch_slice=batch_slice,
                                    composed=composed)


def batched_rmw_fn(params: Params, mesh: MultihostMesh, collective: str = "ring",
                   composed: bool = False):
    """mesh.batched_rmw_fn over the global mesh: B DISTINCT addresses over
    every process's dp slices.  Each process runs its slices' forward walks,
    traces and delta walks against its rows shards and adds its replicas'
    delta sums; one int32 all_reduce(SUM) a rows shard adds every process's
    sums; each rows shard then takes one normalize(data + upd).

    Call as fn(data, coords_prep_b, coords_coeff_b, w_b, keys), the batches
    from host_local_batch, on every process of the group -> (this process's
    read-outs, a list over its dp slices of lists over rows shards of [B /
    dp, W, C, L, N]; the NEW row shards, equal on every process).
    composed: the composed routes (a two-pass context), the counterpart of
    the JAX package's multi-process runs under FHERAM_MXU=0; the same
    integers."""
    ctx = mesh_mod._prepare(params, mesh.local, collective, composed)

    @torch.no_grad()
    def fn(data, coords_prep_b, coords_coeff_b, w_b, keys):
        data = mesh_mod._check_data(mesh.local, data)
        outs, total = mesh_mod._rmw_batch_replicas(
            params, ctx, mesh.local, data, coords_prep_b, coords_coeff_b, w_b, keys,
            collective)
        for t in total:
            torch_dist.all_reduce(t, op=torch_dist.ReduceOp.SUM, group=mesh.group)
        return outs, [limb_ops.normalize(d + u) for d, u in zip(data, total)]
    return fn
