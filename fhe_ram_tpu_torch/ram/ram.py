"""The FHE-RAM engine: encrypted read / read_prepare_write / write, the
batched read and the batched read-modify-write.

  * all WORDSIZE subrams are batched into one leading axis;
  * per-row CMux external products are batched over the row axis;
  * packing is the log-depth batched tree (core/packer.py);
  * the write's per-slot extraction is a log-depth binary split tree
    (core/keyswitch.extract_slots);
  * state is explicit: a RamState in, ciphertexts and a RamState out.
    Nothing is updated in place: read_prepare_write hands the data tensor
    it was given on to the pending state (no copy), and write returns a
    new data tensor and leaves the old one as it was.

State layout:
  data: int32[W, R, C, L, N]      (W subrams, R = ceil(max_addr/N) rows)
  tree: tuple of int32[W, R_i, C, L, N]  (persistent packing levels,
        empty outside a pending write)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..params import Params
from ..ops.ntt import NTTContext, get_ntt_context
from ..ops import limb as limb_ops
from ..ops import ntt_cuda
from ..core import glwe, ggsw, keyswitch, packer, rng
from ..core import keys as keys_mod
from . import address as address_mod


# --------------------------------------------------------------------------
# client side: RAM encryption
# --------------------------------------------------------------------------

def encrypt_ram(params: Params, ctx: NTTContext, s_ntt, data_bytes,
                source: rng.Source):
    """Encrypt the RAM content on s_ntt's device: byte j of word i lands
    in subram j, encoded as a signed i8 at precision k_pt, N values per
    GLWE row.  A payload of the wrong size is refused."""
    W = params.word_size
    R = params.num_rows
    n = params.n
    if isinstance(data_bytes, (bytes, bytearray)):
        data_bytes = np.frombuffer(data_bytes, dtype=np.uint8)
    data_bytes = np.asarray(data_bytes, dtype=np.uint8)
    if data_bytes.size != params.max_addr * W:
        raise ValueError(f"RAM payload of {data_bytes.size} bytes, "
                         f"{params.max_addr * W} expected")
    words = data_bytes.reshape(params.max_addr, W)
    signed = words.astype(np.int8).astype(np.int32)  # i8 cast
    padded = np.zeros((R * n, W), dtype=np.int32)
    padded[: params.max_addr] = signed
    vals = np.ascontiguousarray(padded.T).reshape(W, R, n)  # [W, R, N]
    pt = glwe.encode_vec(params, vals, device=s_ntt.device)  # [W, R, L, N]
    return glwe.encrypt(params, ctx, s_ntt, pt, source)  # [W, R, C, L, N]


def make_tree(params: Params, device="cuda"):
    """Zero-initialized persistent packing tree: one int32[W, R_i, C, L, N]
    a level of params.tree_shape(), on `device` (default: the GPU; a
    missing GPU raises)."""
    device = ntt_cuda.require_device(device)
    C = params.rank + 1
    return tuple(
        torch.zeros((params.word_size, r, C, params.limbs_ct, params.n),
                    dtype=torch.int32, device=device)
        for r in params.tree_shape())


def encrypt_write_word(params: Params, ctx: NTTContext, s_ntt, word_bytes,
                       source: rng.Source):
    """Encrypt a word to write, on s_ntt's device: per byte one GLWE of
    [w, 0, ..., 0].  Returns int32[W, C, L, N]."""
    W = params.word_size
    word = np.asarray(word_bytes, dtype=np.uint8)
    if word.size != W:
        raise ValueError(f"write word of {word.size} bytes, {W} expected")
    vals = np.zeros((W, params.n), dtype=np.int32)
    vals[:, 0] = word.astype(np.int8)
    pt = glwe.encode_vec(params, vals, device=s_ntt.device)
    return glwe.encrypt(params, ctx, s_ntt, pt, source)


# --------------------------------------------------------------------------
# server side: read, batched read, read_prepare_write, write
# --------------------------------------------------------------------------

def _pack_leaves(rows):
    """One chunk's rows [W, Rc, C, L, N] as pack leaves [M, W, C, L, N],
    padded with zero ciphertexts to a power of two."""
    W, Rc = rows.shape[0], rows.shape[1]
    M = 1 << (Rc - 1).bit_length() if Rc > 1 else 1
    if M != Rc:
        pad = rows.new_zeros((W, M - Rc) + tuple(rows.shape[2:]))
        rows = torch.cat([rows, pad], dim=1)
    return rows.movedim(1, 0)


def _pack_rows(params: Params, ctx: NTTContext, cur, atk,
               trunc: tuple = (None, None), tree: bool = False):
    """Pack each N-row chunk's slot-0s into one row: [W, R, C, L, N] ->
    [W, ceil(R/N), C, L, N].  tree: see packer.pack."""
    n = params.n
    chunks = -(-cur.shape[1] // n)
    outs = [packer.pack(params, ctx, _pack_leaves(cur[:, c * n: (c + 1) * n]),
                        atk, trunc=trunc, tree=tree)
            for c in range(chunks)]
    return torch.stack(outs, dim=1)


def read_impl(params: Params, ctx: NTTContext, data, coords, atk,
              tree: bool = False):
    """Encrypted read, all subrams batched.  coords: tuple of prepared
    coordinates; atk: {g: prepared trace key}; tree: the one-launch pack
    tree where the pack runs the full gadget (packer.pack).

    Read results are ephemeral, so the whole pipeline runs with the
    params' READ-path gadget truncation (the write path never
    truncates)."""
    ept, kst = params.read_ep_trunc, params.read_ks_trunc
    n2 = len(coords)
    cur = data
    for i in range(n2 - 1):
        cur = address_mod.coordinate_product(params, ctx, cur, coords[i],
                                             trunc=ept)
        cur = _pack_rows(params, ctx, cur, atk, trunc=kst, tree=tree)
    cur = address_mod.coordinate_product(params, ctx, cur[:, 0],
                                         coords[n2 - 1], trunc=ept)
    return keyswitch.trace(params, ctx, cur, atk, trunc=kst)  # [W, C, L, N]


def read_batch_impl(params: Params, ctx: NTTContext, data, coords_b, atk,
                    data_ntt=None, tree: bool = False):
    """Batched encrypted read at A addresses.  coords_b: tuple of stacked
    prepared coordinates, leading axis A.  Returns int32[A, W, C, L, N],
    the same integers as A single reads.

    Address-independent work is shared instead of repeated:
      * the level-0 forward NTT of the RAM's gadget digits runs once per
        call (the shared spectral input of the batched fold kernel), or
        not at all when the caller passes data_ntt (FheRam.spectral_cache);
      * every level's CMux chains run with per-address keys in one launch;
      * pack and trace run with the batch folded into the row axis (A*W
        rows a launch; rows of a pack are independent, so the integers are
        those of a per-address pack).
    The level-0 output is A times the RAM's size: callers split a large
    batch (FheRam.read_batch does, by its batch_slice argument).
    tree: the one-launch pack tree where the folded pack runs the full
    gadget (packer.pack)."""
    ept, kst = params.read_ep_trunc, params.read_ks_trunc
    n2 = len(coords_b)
    A = coords_b[0].shape[0]
    W = data.shape[0]
    # [A, W, R, C, L, N]
    cur = address_mod.coordinate_product_batched(params, ctx, data,
                                                 coords_b[0], data_ntt,
                                                 trunc=ept)
    for i in range(1, n2):
        flat = cur.reshape((A * W,) + cur.shape[2:])
        flat = _pack_rows(params, ctx, flat, atk, trunc=kst, tree=tree)
        cur = flat.reshape((A, W) + flat.shape[1:])
        if i == n2 - 1:
            cur = cur[:, :, 0]  # [A, W, C, L, N]
        cur = address_mod.coordinate_product_perbatch(params, ctx, cur,
                                                      coords_b[i], trunc=ept)
    if n2 == 1:
        cur = cur[:, :, 0]
    out = keyswitch.trace(params, ctx,
                          cur.reshape((A * W,) + cur.shape[2:]), atk,
                          trunc=kst)
    return out.reshape((A, W) + out.shape[1:])


def rpw_impl(params: Params, ctx: NTTContext, data, coords, atk,
             pack_tree: bool = False):
    """read_prepare_write: the read's output, plus the rotated levels the
    write needs.  Returns (out, data, tree).  pack_tree: the one-launch
    pack tree (packer.pack).

    Exact data carry: the write's final inverse product distributes over
    the delta add,

        inv0 (x) (X^-a0 data + t_d)  =  data + inv0 (x) t_d,

    so the rotated base level is never persisted: the state keeps the
    ORIGINAL data rows exactly and write adds the inverse-rotated delta
    rows.  Carried rows pass no external product.

    The products and packs here feed the write only through the delta, so
    they run the params' RPW-path truncation (none by default); the final
    trace (the read-out, ephemeral) uses the READ truncation."""
    ept, kst = params.rpw_ep_trunc, params.rpw_ks_trunc
    n2 = len(coords)
    levels = []
    cur = data
    for i in range(n2):
        cur = address_mod.coordinate_product(params, ctx, cur, coords[i],
                                             trunc=ept)
        levels.append(cur)
        if i < n2 - 1:
            cur = _pack_rows(params, ctx, cur, atk, trunc=kst, tree=pack_tree)
    out = keyswitch.trace(params, ctx, levels[-1][:, 0], atk,
                          trunc=params.read_ks_trunc)
    # persist only the levels the write reads: the packed upper levels
    # (the root carries the read slot); for the single-level geometry the
    # rotated base IS the root
    tree = tuple(levels[1:]) if n2 > 1 else (levels[0],)
    return out, data, tree


def _invert_coordinate(params: Params, ctx: NTTContext, coord, keys):
    """GGSW(X^e) digits (coefficient domain) -> prepared GGSW(X^-e)
    digits (write path)."""
    inv = [keys_mod.ggsw_automorphism_inv(params, ctx, coord[i], keys)
           for i in range(coord.shape[0])]
    return ggsw.prepare(ctx, torch.stack(inv, dim=0))


def _invert_coordinates_batched(params: Params, ctx: NTTContext, coords_b,
                                keys):
    """`_invert_coordinate` of a batch of coordinates [B, dig, D, C, C2,
    Lg, N] -> [B, P, dig, D, C, C2, Lg, N], the integers of B separate
    calls.  Every address's GGSW rows go against the same two keys, so
    each inversion step is one launch over all B * dig * D rows, not B."""
    inv = keys_mod.ggsw_automorphism_inv(params, ctx, coords_b, keys)
    return ggsw.prepare(ctx, inv).movedim(0, 1)


def write_impl(params: Params, ctx: NTTContext, data, tree, w, addr_coords,
               keys: keys_mod.EvaluationKeysPrepared, split_tree: bool = False):
    """Encrypted write.  addr_coords: tuple of COEFFICIENT-domain
    coordinates (the inverse GGSWs are derived homomorphically in here).
    data is the original (un-rotated) RAM, which rpw_impl carries exactly,
    and tree the persisted packed levels; returns the new data.

    The walk propagates only the delta down the tree: root delta
    (w - trace(root)) -> per-slot extracted deltas -> inverse-rotated
    base delta rows, and the last step is data + inv0 (x) deltas.
    split_tree: the one-launch split tree (keyswitch.extract_slots)."""
    atk = keys.atk_glwe
    n = params.n
    n2 = len(addr_coords)

    root = tree[-1][:, 0]  # [W, C, L, N]
    t = keyswitch.trace(params, ctx, root, atk, trunc=params.rpw_ks_trunc)
    deltas = limb_ops.normalize(w - t)[:, None]  # [W, R_last(=1), C, L, N]

    # mid steps, batched over slots: walk the delta down to base-level row
    # granularity
    for i in range(n2 - 2, -1, -1):
        inv = _invert_coordinate(params, ctx, addr_coords[i + 1], keys)
        chunks = deltas.shape[1]
        rows_i = data.shape[1] if i == 0 else tree[i - 1].shape[1]
        delta_next = []
        for j in range(chunks):
            d_lo = address_mod.coordinate_product(params, ctx, deltas[:, j], inv)
            Rc = min(n, rows_i - j * n)
            # t_d[:, m] = trace(X^-m d_lo).  d_lo's plaintext is exactly
            # [delta at the written row index < Rc], so the support is
            # bounded and the per-leaf tail traces are skipped
            delta_next.append(keyswitch.extract_slots(
                params, ctx, d_lo, Rc, atk, bounded_support=True,
                tree=split_tree))
        deltas = torch.cat(delta_next, dim=1)

    # last step: inverse-rotate the delta rows and add them to the exact
    # carried data
    inv0 = _invert_coordinate(params, ctx, addr_coords[0], keys)
    upd = address_mod.coordinate_product(params, ctx, deltas, inv0)
    return limb_ops.normalize(data + upd)


def rmw_batch_impl(params: Params, ctx: NTTContext, data, coords_prep_b,
                   coords_coeff_b, w_b, keys: keys_mod.EvaluationKeysPrepared,
                   data_ntt=None, tree: bool = False):
    """Batched read-modify-write at B DISTINCT encrypted addresses in one
    call.  The exact-data-carry write makes it possible: rpw leaves the
    data untouched, so B deltas simply ADD:
    data' = data + sum_b inv0_b (x) t_d_b.

    Semantics: all B reads see the PRE-write state (those of a vectorised
    store).  Addresses must be DISTINCT -- a duplicated address would sum
    two (w - old) deltas; this cannot be checked under encryption, so it
    is the caller's contract (as for any parallel store).

    coords_prep_b:  tuple over coordinates of stacked PREPARED coordinates
        [B, P, dig, ...] (convert.stack_addresses);
    coords_coeff_b: the same stacking of the COEFFICIENT-domain
        coordinates (the inverse GGSWs are derived in here);
    w_b: int32[B, W, C, L, N] encrypted write words.

    Returns (outs, new_data): outs int32[B, W, C, L, N] -- the values AT
    the addresses before the write (from the same full-gadget root trace
    that feeds the delta, so slightly LESS noisy than a truncated batched
    read); new_data a new tensor (data is left as it was).

    Generic in geometry: any n2 and any row count -- the forward walk
    packs level by level (multi-chunk packs like _pack_rows), and the
    delta walk loops the mid levels like write_impl (one extraction per
    pack chunk per level).  Shared across the batch: the level-0
    transform (or none with data_ntt), every level's products with
    per-address keys in one launch, pack, trace and extraction with the
    batch folded into the row axis (rows are independent: the integers are
    those of a per-address walk), and each GGSW inversion step in one
    launch for all addresses.  tree: the one-launch pack and split trees."""
    n2 = len(coords_prep_b)
    B = coords_prep_b[0].shape[0]
    W, R = data.shape[0], data.shape[1]
    atk = keys.atk_glwe
    n = params.n
    # rows entering the level-i product: the RAM, then each tree level
    rows_levels = [R] + params.tree_shape()

    # rpw forward walk, batched: full gadget (the tree feeds the write)
    cur = address_mod.coordinate_product_batched(params, ctx, data,
                                                 coords_prep_b[0], data_ntt)
    for i in range(1, n2):
        flat = cur.reshape((B * W,) + cur.shape[2:])
        flat = _pack_rows(params, ctx, flat, atk, tree=tree)
        cur = flat.reshape((B, W) + flat.shape[1:])  # [B, W, chunks, ...]
        if i == n2 - 1:
            cur = cur[:, :, 0]  # [B, W, C, L, N]
        cur = address_mod.coordinate_product_perbatch(params, ctx, cur,
                                                      coords_prep_b[i])
    root = cur if n2 > 1 else cur[:, :, 0]

    # one FULL trace serves both the read-out and the delta
    t = keyswitch.trace(params, ctx,
                        root.reshape((B * W,) + root.shape[2:]), atk)
    outs = t.reshape((B, W) + t.shape[1:])
    deltas = limb_ops.normalize(w_b - outs)[:, :, None]  # [B, W, 1, C, L, N]

    # walk each delta down to base-row granularity, mirroring write_impl's
    # mid loop: per level, per pack chunk, one inverse CMux and one bounded
    # split-tree extraction
    for i in range(n2 - 2, -1, -1):
        inv_b = _invert_coordinates_batched(params, ctx, coords_coeff_b[i + 1],
                                            keys)
        chunks = deltas.shape[2]
        rows_i = rows_levels[i]
        parts = []
        for j in range(chunks):
            d_lo = address_mod.coordinate_product_perbatch(
                params, ctx, deltas[:, :, j], inv_b)
            Rc = min(n, rows_i - j * n)
            # extract_slots puts the slot axis at -4 -> [B, W, Rc, ...]
            parts.append(keyswitch.extract_slots(
                params, ctx, d_lo, Rc, atk, bounded_support=True, tree=tree))
        deltas = torch.cat(parts, dim=2)

    inv0_b = _invert_coordinates_batched(params, ctx, coords_coeff_b[0], keys)
    upd = address_mod.coordinate_product_perbatch(params, ctx, deltas, inv0_b)
    new_data = limb_ops.normalize(data + upd.sum(dim=0, dtype=torch.int32))
    return outs, new_data


# --------------------------------------------------------------------------
# orchestration
# --------------------------------------------------------------------------

@dataclass
class RamState:
    """Carried RAM state: the encrypted data and, between
    read_prepare_write and write, the persisted rotated tree plus the
    protocol flag.  The flag travels WITH the (data, tree) pair."""

    data: torch.Tensor
    tree: tuple
    pending: bool


class FheRam:
    """Server-side FHE-RAM: static params + prepared keys on one device.

    device defaults to the GPU; a missing GPU raises (pass device="cpu"
    to run the plain versions, as the tests do).  Every tensor handed to a
    method must lie on the server's device.

    Protocol: read_prepare_write makes the state pending; only write takes
    a pending state, and write takes no other.

    tree_kernels=True runs every full-gadget pack of at most 32 leaves
    (wider ones after per-level merges down to 32) and every slot
    extraction of at most 64 slots in ONE kernel launch each instead of
    one a level; all results are the same integers.

    composed=True is the composed configuration, the counterpart of the
    JAX package's FHERAM_NTT=pallas FHERAM_MXU=0: the server's context has
    the two-pass transform body (ops.ntt), and every pack merge, trace
    step and split level is torch glue around one launch of the fold
    kernel (ops.ntt_cuda.pack_merge_level, trace_step, split_level) instead
    of a launch of the merge, trace or split kernel.  The same integers as
    the default.  It refuses tree_kernels=True (the trees have no two-pass
    body) and a spectral cache for chained CMux digits (the JAX package's
    MXU=0 fold refuses chained spectral input; single-digit coordinates,
    as at every wide-digit preset, take the cache).  The JAX package's
    _chunked_product and _merge_level_chunked only bound XLA's memory and
    give the same integers; the fold kernel streams its rows, so they are
    not carried over."""

    def __init__(self, params: Params,
                 keys_prepared: keys_mod.EvaluationKeysPrepared,
                 device="cuda", tree_kernels: bool = False,
                 composed: bool = False):
        if tree_kernels and composed:
            raise ValueError("tree_kernels=True needs the fused routes: the "
                             "one-launch trees have no two-pass body")
        self.params = params
        self.tree_kernels = bool(tree_kernels)
        self.device = ntt_cuda.require_device(device)
        self.ctx = get_ntt_context(params.n, params.primes,
                                   "two_pass" if composed else "radix2")
        self.keys = keys_prepared
        for g, k in keys_prepared.atk_glwe.items():
            self._on_device(f"trace key g={g}", k)
        for g, k in keys_prepared.atk_ggsw.items():
            self._on_device(f"GGSW automorphism key g={g}", k)
        if keys_prepared.tsk is not None:
            self._on_device("tensor key", keys_prepared.tsk)

    def _on_device(self, what: str, *tensors):
        for t in tensors:
            if t.device.type != self.device.type:
                raise ValueError(f"{what} lies on {t.device}, server on {self.device}")

    def init_state(self, data) -> RamState:
        """Wrap freshly encrypted RAM data (ram.encrypt_ram output)."""
        self._on_device("RAM data", data)
        return RamState(data=data, tree=(), pending=False)

    @torch.no_grad()
    def spectral_cache(self, state: RamState):
        """Forward transforms of the RAM's gadget-digit rows, reusable
        across read / read_batch calls on THIS state (the level-0 forward
        NTT is address-independent).  Recompute after every write: a stale
        cache reads the pre-write RAM."""
        assert not state.pending, "pending write: call write() first"
        return address_mod.spectral_cache(self.params, self.ctx, state.data)

    @torch.no_grad()
    def read(self, state: RamState, addr_prep: address_mod.AddressPrepared,
             cache=None):
        assert not state.pending, "pending write: call write() first"
        self._on_device("address", *addr_prep.coordinates)
        if cache is not None:
            self._on_device("spectral cache", cache)
            coords_b = tuple(c[None] for c in addr_prep.coordinates)
            return read_batch_impl(self.params, self.ctx, state.data, coords_b,
                                   self.keys.atk_glwe, cache,
                                   tree=self.tree_kernels)[0]
        return read_impl(self.params, self.ctx, state.data,
                         addr_prep.coordinates, self.keys.atk_glwe,
                         tree=self.tree_kernels)

    @torch.no_grad()
    def read_batch(self, state: RamState, addrs_prep, cache=None,
                   batch_slice: int = 64):
        """Batched reads at many addresses.  addrs_prep: tuple of prepared
        coordinates stacked on axis 0 (convert.stack_addresses).  Returns
        int32[A, W, C, L, N].  More than batch_slice addresses run as
        consecutive slices of that size: the level-0 intermediate of one
        slice is batch_slice times the RAM's ciphertext."""
        assert not state.pending, "pending write: call write() first"
        if batch_slice < 1:
            raise ValueError(f"batch_slice = {batch_slice}")
        self._on_device("addresses", *addrs_prep)
        if cache is not None:
            self._on_device("spectral cache", cache)
        A = addrs_prep[0].shape[0]
        outs = [read_batch_impl(self.params, self.ctx, state.data,
                                tuple(c[a0: a0 + batch_slice] for c in addrs_prep),
                                self.keys.atk_glwe, cache, tree=self.tree_kernels)
                for a0 in range(0, A, batch_slice)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    @torch.no_grad()
    def rmw_batch(self, state: RamState, addrs_prep, addrs_coeff, w_b):
        """Batched read-modify-write at B DISTINCT encrypted addresses
        (rmw_batch_impl): ONE call reads all B pre-write values and writes
        all B words.  addrs_prep / addrs_coeff: the prepared and the
        coefficient-domain coordinates of the same addresses, each stacked
        on axis 0 (convert.stack_addresses); w_b: int32[B, W, C, L, N]
        (ram.encrypt_write_word, stacked).  Returns (outs int32[B, W, C, L,
        N], new state with a new data tensor).  Distinct addresses are the caller's contract
        (those of a parallel store: a duplicate would sum its deltas)."""
        assert not state.pending, "pending write: call write() first"
        self._on_device("addresses", *addrs_prep)
        self._on_device("addresses", *addrs_coeff)
        self._on_device("write words", w_b)
        outs, new_data = rmw_batch_impl(
            self.params, self.ctx, state.data, addrs_prep, addrs_coeff, w_b,
            self.keys, tree=self.tree_kernels)
        return outs, RamState(data=new_data, tree=(), pending=False)

    @torch.no_grad()
    def read_prepare_write(self, state: RamState,
                           addr_prep: address_mod.AddressPrepared):
        """Returns (read output, pending state).  The pending state shares
        its data tensor with `state`."""
        assert not state.pending, "pending write: call write() first"
        self._on_device("address", *addr_prep.coordinates)
        out, data, tree = rpw_impl(self.params, self.ctx, state.data,
                                   addr_prep.coordinates, self.keys.atk_glwe,
                                   pack_tree=self.tree_kernels)
        return out, RamState(data=data, tree=tree, pending=True)

    @torch.no_grad()
    def write(self, state: RamState, w, addr: address_mod.Address):
        """Write the encrypted word w (ram.encrypt_write_word) at the
        address the pending state was prepared for; addr is that address
        in the COEFFICIENT domain.  Returns a new state with a new data
        tensor; the pending state's tensors are left as they were."""
        assert state.pending, "write requires read_prepare_write first"
        self._on_device("write word", w)
        self._on_device("address", *addr.coordinates)
        new_data = write_impl(self.params, self.ctx, state.data, state.tree,
                              w, addr.coordinates, self.keys,
                              split_tree=self.tree_kernels)
        return RamState(data=new_data, tree=(), pending=False)
