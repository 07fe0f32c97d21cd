"""Row-sharded execution: the encrypted RAM's rows over the `rows` shards of
a (dp, rows) mesh, addresses of a batch over its `dp` replicas.

Counterpart of fhe_ram_tpu/parallel/mesh.py, with its single-controller
model: one process drives every shard.  What the reference's shard_map
does, here:

  * a Mesh is a (dp, rows) grid of torch devices.  Only one card so far:
    every entry is the same device (on the CPU, "cpu"), and a mesh over
    distinct cards raises NotImplementedError;
  * a row-sharded tensor is a list, one tensor a rows index; a dp-sharded
    batch a list, one slice a dp index.  Replication over dp shares the
    rows list and is never copied on one card;
  * the shard_map body runs once a shard: a Python loop over the shards,
    with `my` = the rows index where the reference has
    lax.axis_index("rows").  The loop stops at each collective, which
    takes all shards' chunks at once (parallel/collective.py);
  * replicated work runs on every shard, as in the reference: the tail
    merges, the level-1 product, the trace, the write's inverse
    coordinates.  A value computed on every rows shard comes back as the
    list of the shards' copies, all equal.

Row sharding is STRIDED: shard k holds the global rows congruent to k
(mod n_shards), local row j = global row j * n_shards + k.  The log-depth
pack tree (core/packer.py) merges leaves at stride 2^l on level l, largest
stride first, so the first log2(R / n_shards) levels pair leaves WITHIN a
shard: each shard runs them with the dilated tree (packer.pack_tree(
dilate=n_shards)), the shards' roots (one GLWE each) are gathered, and the
last log2(n_shards) merges run replicated -- or, with collective=
"exchange", each of those merges takes the XOR partner's node as it
arrives (recursive doubling).  The write walks the delta back the same way:
replicated inverse CMux, the split tree's first log2(n_shards) levels on
every shard, then each shard keeps the subtree of its residue
(keyswitch.extract_slots(dilate, residue)), and the inverse base products
and delta adds are row-local.

Nothing is updated in place: the write functions return new data shards
(the reference donates its input buffer instead)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..params import Params
from ..convert import stack_addresses  # noqa: F401  (the reference's mesh.stack_addresses)
from ..ops.ntt import get_ntt_context
from ..ops import limb as limb_ops
from ..ops.ntt_cuda import require_device
from ..core import keyswitch, packer
from ..ram import address as address_mod
from ..ram import ram as ram_mod
from . import collective as collective_mod


# --------------------------------------------------------------------------
# the mesh and placement
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Mesh:
    """devices[d][k]: the device of dp index d, rows index k."""

    devices: tuple

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def rows(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "rows": self.rows}

    @property
    def device(self) -> torch.device:
        return self.devices[0][0]


def _device_key(d: torch.device):
    if d.type == "cuda" and d.index is None:
        return ("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return (d.type, d.index)


def make_mesh(n_devices: int | None = None, rows: int = 1, devices=None) -> Mesh:
    """Mesh with axes (dp, rows); rows divides n_devices.  devices: the
    mesh's n_devices entries, in (dp, rows) order (default: the card,
    n_devices times).  Every entry must be one and the same device: a mesh
    over distinct cards is not ported yet and raises NotImplementedError."""
    if devices is None:
        devs = [require_device("cuda")] * (n_devices or 1)
    else:
        devs = [torch.device(d) for d in devices]
    n = n_devices or len(devs)
    if not 1 <= n <= len(devs) or rows < 1 or n % rows:
        raise ValueError(f"{n} devices of {len(devs)} in rows of {rows}")
    devs = devs[:n]
    if len({_device_key(d) for d in devs}) > 1:
        raise NotImplementedError(
            f"a mesh over distinct devices {sorted({str(d) for d in devs})} is "
            "not ported yet (ROADMAP.md, queue 1: a mesh over distinct cards, "
            "with peer-mapped pointer tables); give every entry the same card")
    require_device(devs[0])
    return Mesh(tuple(tuple(devs[d * rows: (d + 1) * rows])
                      for d in range(n // rows)))


def replicated(mesh: Mesh, x):
    """x (a tensor, or a dict / tuple / list of them, nested) on the mesh's
    device: every shard reads the same copy."""
    if torch.is_tensor(x):
        return x.to(mesh.device)
    if isinstance(x, dict):
        return {k: replicated(mesh, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(replicated(mesh, v) for v in x)
    if hasattr(x, "__dataclass_fields__"):
        return type(x)(**{f: replicated(mesh, getattr(x, f))
                          for f in x.__dataclass_fields__})
    return x


def row_shard_perm(num_rows: int, n_shards: int) -> np.ndarray:
    """Row permutation realizing the strided shard layout: permuted
    position k*R_loc + j holds global row j*n_shards + k, so contiguous
    shards hold the rows congruent to k (mod n_shards)."""
    if num_rows % n_shards:
        raise ValueError(f"{num_rows} rows over {n_shards} shards")
    return np.arange(num_rows).reshape(num_rows // n_shards, n_shards).T.reshape(-1)


def shard_data_rows(mesh: Mesh, data) -> list:
    """RAM data [W, R, C, L, N] as the mesh's row shards: a list of
    `rows` tensors [W, R / rows, C, L, N], shard k holding the global rows
    congruent to k (the permuted order's k-th contiguous block)."""
    r = mesh.rows
    if data.shape[1] % r:
        raise ValueError(f"{data.shape[1]} rows over {r} shards")
    return [data[:, k::r].contiguous().to(mesh.device) for k in range(r)]


def unshard_rows(shards) -> torch.Tensor:
    """Inverse of shard_data_rows: the row shards back as one [W, R, C, L,
    N] tensor in global row order."""
    W, R_loc = shards[0].shape[0], shards[0].shape[1]
    stacked = torch.stack(list(shards), dim=2)  # [W, R_loc, n, C, L, N]
    return stacked.reshape((W, R_loc * len(shards)) + tuple(shards[0].shape[2:]))


def shard_addr_batch(mesh: Mesh, batch) -> list:
    """A stacked batch (a tuple of [B, ...] tensors, or one such tensor)
    split over dp: a list of `dp` slices of B / dp items (views)."""
    dp = mesh.dp
    parts = batch if isinstance(batch, tuple) else (batch,)
    B = parts[0].shape[0]
    if B % dp:
        raise ValueError(f"a batch of {B} over {dp} dp replicas")
    b = B // dp
    out = [tuple(p[d * b: (d + 1) * b].to(mesh.device) for p in parts)
           for d in range(dp)]
    return out if isinstance(batch, tuple) else [o[0] for o in out]


# --------------------------------------------------------------------------
# the sharded pack: local dilated trees, then the gathered or exchanged tail
# --------------------------------------------------------------------------

def _pack_rows_sharded(params: Params, ctx, cur, atk, collective: str,
                       trunc: tuple = (None, None)):
    """Sharded counterpart of ram._pack_rows for R_global <= N (one chunk):
    cur, a list over rows shards of [W', R_loc, C, L, N] (strided global
    rows) -> a list over rows shards of [W', 1, C, L, N], all equal."""
    n_shards = len(cur)
    roots = [packer.pack_tree(params, ctx, ram_mod._pack_leaves(c), atk,
                              dilate=n_shards, prescale=True, trunc=trunc)
             for c in cur]
    if n_shards > 1:
        if collective == "exchange":
            roots = _merge_exchange_tail(params, ctx, roots, atk, trunc)
        else:
            nodes = collective_mod.ring_all_gather(roots)
            roots = [packer.pack_tree(params, ctx, nd, atk, dilate=1,
                                      prescale=False, trunc=trunc)
                     for nd in nodes]
    return [r[:, None] for r in roots]


def _merge_exchange_tail(params: Params, ctx, roots, atk,
                         trunc: tuple = (None, None)):
    """The pack tail with communication consumed in arrival order:
    recursive doubling over the rows shards.

    Shard k's local dilated root is tail-tree node k (slots congruent to k
    mod n_shards).  Tail level ll of pack_tree(dilate=1) merges nodes (j,
    j + 2^ll) -> j with stride 2^ll and galois (N >> ll) + 1, largest ll
    first; before that round shard k holds node (k mod 2^(ll+1)) and its
    partner k XOR 2^ll the node that differs in bit ll -- the pair.  Bit ll
    of k picks which is A (the low node) and which is B.  The same
    _merge_level calls on the same operands as the gathered tail, so the
    result is bit-exact and replicated."""
    n_shards = len(roots)
    n = params.n
    cur = roots
    for ll in range((n_shards.bit_length() - 1) - 1, -1, -1):
        s = 1 << ll
        g = (n >> ll) + 1
        other = collective_mod.exchange(cur, s)
        nxt = []
        for my in range(n_shards):
            hi = (my >> ll) & 1
            A, B = (other[my], cur[my]) if hi else (cur[my], other[my])
            nxt.append(packer._merge_level(params, ctx, A, B, s, g, atk[g],
                                           trunc=trunc))
        cur = nxt
    return cur


def _check_shardable(params: Params, mesh: Mesh):
    if params.num_rows > params.n:
        raise ValueError(
            f"{params.num_rows} rows > N = {params.n}: the row-sharded paths "
            "support one pack chunk (2^24 at N = 4096 is exactly the bound)")
    if params.n2 != 2:
        raise ValueError(f"n2 = {params.n2}: the row-sharded paths expect the "
                         "2-level geometry")
    r = mesh.rows
    if r & (r - 1) or params.num_rows % r:
        raise ValueError(f"{r} rows shards: a power of two dividing "
                         f"{params.num_rows} rows")


def _check_data(mesh: Mesh, data) -> list:
    data = list(data)
    if len(data) != mesh.rows:
        raise ValueError(f"{len(data)} data shards for {mesh.rows} rows shards")
    return data


# --------------------------------------------------------------------------
# the bodies, a loop over the shards between two collectives
# --------------------------------------------------------------------------

def _forward_walk(params: Params, ctx, data, coords, atk, collective: str,
                  ept, kst):
    """Level-0 products over each shard's rows, the sharded pack, and the
    replicated level-1 product: a list over rows shards of [W, C, L, N]."""
    cur = [address_mod.coordinate_product(params, ctx, d, coords[0], trunc=ept)
           for d in data]
    packed = _pack_rows_sharded(params, ctx, cur, atk, collective, trunc=kst)
    return [address_mod.coordinate_product(params, ctx, p[:, 0], coords[1],
                                           trunc=ept) for p in packed]


def _delta_walk(params: Params, ctx, data, deltas, coords_coeff, keys):
    """Walk each shard's copy of the root delta [W, 1, C, L, N] down to
    its own rows and add (ram.write_impl restructured for the strided
    layout): replicated inverse CMux, the split tree's residue subtree,
    row-local inverse base products."""
    atk = keys.atk_glwe
    n_shards = len(data)
    out = []
    for my, (d, delta) in enumerate(zip(data, deltas)):
        inv1 = ram_mod._invert_coordinate(params, ctx, coords_coeff[1], keys)
        d_lo = address_mod.coordinate_product(params, ctx, delta[:, 0], inv1)
        t_d = keyswitch.extract_slots(params, ctx, d_lo, params.num_rows, atk,
                                      bounded_support=True, dilate=n_shards,
                                      residue=my)
        inv0 = ram_mod._invert_coordinate(params, ctx, coords_coeff[0], keys)
        upd = address_mod.coordinate_product(params, ctx, t_d, inv0)
        out.append(limb_ops.normalize(d + upd))
    return out


def _batch_forward_walk(params: Params, ctx, data, coords_b, atk,
                        collective: str, ept, kst, data_ntt=None):
    """_forward_walk of a batch of B addresses (ram.read_batch_impl's
    structure with the sharded pack): a list over rows shards of [B, W, C,
    L, N].  data_ntt: each shard's spectral cache, or None."""
    B, W = coords_b[0].shape[0], data[0].shape[0]
    flat = []
    for k, d in enumerate(data):
        cur = address_mod.coordinate_product_batched(
            params, ctx, d, coords_b[0], None if data_ntt is None else data_ntt[k],
            trunc=ept)
        flat.append(cur.reshape((B * W,) + cur.shape[2:]))
    packed = _pack_rows_sharded(params, ctx, flat, atk, collective, trunc=kst)
    del flat
    return [address_mod.coordinate_product_perbatch(
                params, ctx, p.reshape((B, W) + p.shape[1:])[:, :, 0], coords_b[1],
                trunc=ept)
            for p in packed]


def _batch_trace(params: Params, ctx, cur, atk, trunc=(None, None)):
    """trace of [B, W, C, L, N] with the batch folded into the rows."""
    out = keyswitch.trace(params, ctx, cur.reshape((-1,) + cur.shape[2:]), atk,
                          trunc=trunc)
    return out.reshape(cur.shape[:2] + out.shape[1:])


def _batch_slice(params: Params, ctx, data, coords_b, atk, data_ntt,
                 collective: str):
    """One slice of the sharded batched read: a list over rows shards of
    [B, W, C, L, N]."""
    ept, kst = params.read_ep_trunc, params.read_ks_trunc
    roots = _batch_forward_walk(params, ctx, data, coords_b, atk, collective,
                                ept, kst, data_ntt)
    return [_batch_trace(params, ctx, r, atk, kst) for r in roots]


def _rmw_batch_body(params: Params, ctx, data, coords_prep_b, coords_coeff_b,
                    w_b, keys, collective: str):
    """One dp replica's B_loc RMWs against the row shards
    (ram.rmw_batch_impl restructured for the mesh): returns (the read-outs,
    a list over rows shards of [B_loc, W, C, L, N]; the shards' delta sums,
    a list over rows shards of [W, R_loc, C, L, N])."""
    atk = keys.atk_glwe
    n_shards = len(data)
    roots = _batch_forward_walk(params, ctx, data, coords_prep_b, atk, collective,
                                (None, None), (None, None))
    outs, upds = [], []
    for my, root in enumerate(roots):
        t = _batch_trace(params, ctx, root, atk)
        deltas = limb_ops.normalize(w_b - t)
        inv1_b = ram_mod._invert_coordinates_batched(params, ctx,
                                                     coords_coeff_b[1], keys)
        d_lo = address_mod.coordinate_product_perbatch(params, ctx, deltas, inv1_b)
        t_d = keyswitch.extract_slots(params, ctx, d_lo, params.num_rows, atk,
                                      bounded_support=True, dilate=n_shards,
                                      residue=my)
        inv0_b = ram_mod._invert_coordinates_batched(params, ctx,
                                                     coords_coeff_b[0], keys)
        upd = address_mod.coordinate_product_perbatch(params, ctx, t_d, inv0_b)
        outs.append(t)
        upds.append(upd.sum(dim=0, dtype=torch.int32))
    return outs, upds


# --------------------------------------------------------------------------
# the entry points: factory functions, as the reference's jitted ones
# --------------------------------------------------------------------------

def _prepare(params: Params, mesh: Mesh, collective: str | None = None):
    _check_shardable(params, mesh)
    if collective is not None:
        collective_mod.check_collective(collective)
    return get_ntt_context(params.n, params.primes)


def sharded_read_fn(params: Params, mesh: Mesh, collective: str = "ring"):
    """A single read over row-sharded RAM (the 2^24 configuration: strided
    rows over the shards, one pack-root collective, replicated tail).

    Call as fn(data, coords, atk) -> a list over rows shards of the read
    [W, C, L, N], all equal: data from shard_data_rows, coords an
    AddressPrepared's coordinates, atk the prepared trace keys.  dp > 1
    would compute replicas: they share the rows shards' result."""
    ctx = _prepare(params, mesh, collective)

    @torch.no_grad()
    def fn(data, coords, atk):
        data = _check_data(mesh, data)
        cur = _forward_walk(params, ctx, data, coords, atk, collective,
                            params.read_ep_trunc, params.read_ks_trunc)
        return [keyswitch.trace(params, ctx, c, atk, trunc=params.read_ks_trunc)
                for c in cur]
    return fn


def sharded_rmw_fn(params: Params, mesh: Mesh, collective: str = "ring"):
    """A read-modify-write over row-sharded RAM: the rpw forward walk, ONE
    full-gadget root trace serving the read-out and the delta (the
    structure of ram.rmw_batch_impl), then the sharded delta walk.

    Call as fn(data, coords_prep, coords_coeff, w, keys) -> (read_out, a
    list over rows shards of [W, C, L, N], all equal; new data, a list of
    NEW row shards -- the input shards are left as they were): coords_prep
    / coords_coeff an AddressPrepared's / Address's coordinates, w
    int32[W, C, L, N], keys the full EvaluationKeysPrepared."""
    ctx = _prepare(params, mesh, collective)

    @torch.no_grad()
    def fn(data, coords_prep, coords_coeff, w, keys):
        data = _check_data(mesh, data)
        roots = _forward_walk(params, ctx, data, coords_prep, keys.atk_glwe,
                              collective, params.rpw_ep_trunc, params.rpw_ks_trunc)
        t = [keyswitch.trace(params, ctx, r, keys.atk_glwe) for r in roots]
        deltas = [limb_ops.normalize(w - tk)[:, None] for tk in t]
        return t, _delta_walk(params, ctx, data, deltas, coords_coeff, keys)
    return fn


def sharded_rpw_fn(params: Params, mesh: Mesh, collective: str = "ring"):
    """read_prepare_write over row-sharded RAM: fn(data, coords, atk) ->
    (read_out, root), each a list over rows shards, all equal.  The data
    shards are carried exactly (ram.rpw_impl's exact-data-carry write), so
    they are not returned: pass the same shards and the roots [W, 1, C, L,
    N] to sharded_write_fn.  The root runs the RPW truncation, the
    read-out the READ truncation, as ram.rpw_impl."""
    ctx = _prepare(params, mesh, collective)

    @torch.no_grad()
    def fn(data, coords, atk):
        data = _check_data(mesh, data)
        roots = _forward_walk(params, ctx, data, coords, atk, collective,
                              params.rpw_ep_trunc, params.rpw_ks_trunc)
        outs = [keyswitch.trace(params, ctx, r, atk, trunc=params.read_ks_trunc)
                for r in roots]
        return outs, [r[:, None] for r in roots]
    return fn


def sharded_write_fn(params: Params, mesh: Mesh):
    """The write over row-sharded RAM, consuming sharded_rpw_fn's roots:
    fn(data, roots, w, coords_coeff, keys) -> a list of NEW row shards (the
    input shards are left as they were).  As ram.write_impl: each shard's
    root traced at the RPW truncation, the delta walked down to its rows."""
    ctx = _prepare(params, mesh)

    @torch.no_grad()
    def fn(data, roots, w, coords_coeff, keys):
        data = _check_data(mesh, data)
        deltas = []
        for root in roots:
            t = keyswitch.trace(params, ctx, root[:, 0], keys.atk_glwe,
                                trunc=params.rpw_ks_trunc)
            deltas.append(limb_ops.normalize(w - t)[:, None])
        return _delta_walk(params, ctx, data, deltas, coords_coeff, keys)
    return fn


def sharded_spectral_cache_fn(params: Params, mesh: Mesh):
    """Each shard's spectral cache (the address-independent level-0
    transform of its rows' gadget digits): fn(data) -> a list over rows
    shards of [P, W * R_loc, C * L, N], for batched_read_fn(with_cache=True)
    on the SAME shards."""
    ctx = get_ntt_context(params.n, params.primes)

    @torch.no_grad()
    def fn(data):
        return [address_mod.spectral_cache(params, ctx, d)
                for d in _check_data(mesh, data)]
    return fn


def batched_read_fn(params: Params, mesh: Mesh, with_cache: bool = False,
                    collective: str = "ring", batch_slice: int = 64):
    """The sharded batched read: addresses over dp, RAM rows (strided) over
    rows.  Call as fn(data, coords_b, atk), or fn(data, coords_b, atk,
    cache) when with_cache (cache from sharded_spectral_cache_fn on the
    same shards): coords_b from shard_addr_batch (a list over dp of stacked
    coordinates).  Returns a list over dp of lists over rows shards of [B_loc,
    W, C, L, N] (each dp replica's reads, equal on every rows shard).  More
    than batch_slice addresses a replica run as consecutive slices of that
    size, as FheRam.read_batch does."""
    ctx = _prepare(params, mesh, collective)
    if batch_slice < 1:
        raise ValueError(f"batch_slice = {batch_slice}")

    @torch.no_grad()
    def fn(data, coords_b, atk, cache=None):
        data = _check_data(mesh, data)
        if with_cache != (cache is not None):
            raise ValueError(f"with_cache={with_cache}: the cache is "
                             f"{'missing' if with_cache else 'not expected'}")
        if len(coords_b) != mesh.dp:
            raise ValueError(f"{len(coords_b)} address slices for dp = {mesh.dp}")
        out = []
        for coords in coords_b:
            B = coords[0].shape[0]
            slices = [_batch_slice(params, ctx, data,
                                   tuple(c[b0: b0 + batch_slice] for c in coords),
                                   atk, cache, collective)
                      for b0 in range(0, B, batch_slice)]
            out.append([s[0] if len(s) == 1 else torch.cat(s, dim=0)
                        for s in zip(*slices)])
        return out
    return fn


def batched_rmw_fn(params: Params, mesh: Mesh, collective: str = "ring"):
    """The batched read-modify-write over the dp x rows mesh: B DISTINCT
    addresses over dp, RAM rows (strided) over rows.  Each dp replica runs
    its addresses' forward walks, traces and delta walks against the rows
    shards; then the replicas' delta sums are added (the reference's psum
    over dp) and each rows shard takes one normalize(data + upd).  All B
    reads see the pre-write state; distinct addresses are the caller's
    contract (a duplicate would sum its deltas).

    Call as fn(data, coords_prep_b, coords_coeff_b, w_b, keys) -> (outs, a
    list over dp of lists over rows shards of [B_loc, W, C, L, N]; a list of
    NEW row shards): coords and w_b from shard_addr_batch."""
    ctx = _prepare(params, mesh, collective)

    @torch.no_grad()
    def fn(data, coords_prep_b, coords_coeff_b, w_b, keys):
        data = _check_data(mesh, data)
        if not len(coords_prep_b) == len(coords_coeff_b) == len(w_b) == mesh.dp:
            raise ValueError(f"address and word slices for dp = {mesh.dp}")
        outs, total = [], None
        for cp, cc, w in zip(coords_prep_b, coords_coeff_b, w_b):
            o, upds = _rmw_batch_body(params, ctx, data, cp, cc, w, keys,
                                      collective)
            outs.append(o)
            total = upds if total is None else [a + b for a, b in zip(total, upds)]
        return outs, [limb_ops.normalize(d + u) for d, u in zip(data, total)]
    return fn
