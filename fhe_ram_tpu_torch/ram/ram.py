"""The FHE-RAM engine: encrypted read / read_prepare_write / write, and
the batched read.

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

def _pack_rows(params: Params, ctx: NTTContext, cur, atk,
               trunc: tuple = (None, None)):
    """Pack each N-row chunk's slot-0s into one row: [W, R, C, L, N] ->
    [W, ceil(R/N), C, L, N]."""
    W, R = cur.shape[0], cur.shape[1]
    n = params.n
    chunks = -(-R // n)
    outs = []
    for c in range(chunks):
        rows = cur[:, c * n: (c + 1) * n]
        Rc = rows.shape[1]
        M = 1 << (Rc - 1).bit_length() if Rc > 1 else 1
        if M != Rc:
            pad = cur.new_zeros((W, M - Rc) + tuple(rows.shape[2:]))
            rows = torch.cat([rows, pad], dim=1)
        cts = rows.movedim(1, 0)  # [M, W, C, L, N]
        outs.append(packer.pack(params, ctx, cts, atk, trunc=trunc))
    return torch.stack(outs, dim=1)


def read_impl(params: Params, ctx: NTTContext, data, coords, atk):
    """Encrypted read, all subrams batched.  coords: tuple of prepared
    coordinates; atk: {g: prepared trace key}.

    Read results are ephemeral, so the whole pipeline runs with the
    params' READ-path gadget truncation (the write path never
    truncates)."""
    ept, kst = params.read_ep_trunc, params.read_ks_trunc
    n2 = len(coords)
    cur = data
    for i in range(n2 - 1):
        cur = address_mod.coordinate_product(params, ctx, cur, coords[i],
                                             trunc=ept)
        cur = _pack_rows(params, ctx, cur, atk, trunc=kst)
    cur = address_mod.coordinate_product(params, ctx, cur[:, 0],
                                         coords[n2 - 1], trunc=ept)
    return keyswitch.trace(params, ctx, cur, atk, trunc=kst)  # [W, C, L, N]


def read_batch_impl(params: Params, ctx: NTTContext, data, coords_b, atk,
                    data_ntt=None):
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
    batch (FheRam.read_batch does, by its batch_slice argument)."""
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
        flat = _pack_rows(params, ctx, flat, atk, trunc=kst)
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


def rpw_impl(params: Params, ctx: NTTContext, data, coords, atk):
    """read_prepare_write: the read's output, plus the rotated levels the
    write needs.  Returns (out, data, tree).

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
            cur = _pack_rows(params, ctx, cur, atk, trunc=kst)
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


def write_impl(params: Params, ctx: NTTContext, data, tree, w, addr_coords,
               keys: keys_mod.EvaluationKeysPrepared):
    """Encrypted write.  addr_coords: tuple of COEFFICIENT-domain
    coordinates (the inverse GGSWs are derived homomorphically in here).
    data is the original (un-rotated) RAM, which rpw_impl carries exactly,
    and tree the persisted packed levels; returns the new data.

    The walk propagates only the delta down the tree: root delta
    (w - trace(root)) -> per-slot extracted deltas -> inverse-rotated
    base delta rows, and the last step is data + inv0 (x) deltas."""
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
                params, ctx, d_lo, Rc, atk, bounded_support=True))
        deltas = torch.cat(delta_next, dim=1)

    # last step: inverse-rotate the delta rows and add them to the exact
    # carried data
    inv0 = _invert_coordinate(params, ctx, addr_coords[0], keys)
    upd = address_mod.coordinate_product(params, ctx, deltas, inv0)
    return limb_ops.normalize(data + upd)


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
    a pending state, and write takes no other."""

    def __init__(self, params: Params,
                 keys_prepared: keys_mod.EvaluationKeysPrepared,
                 device="cuda"):
        self.params = params
        self.device = ntt_cuda.require_device(device)
        self.ctx = get_ntt_context(params.n, params.primes)
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
                                   self.keys.atk_glwe, cache)[0]
        return read_impl(self.params, self.ctx, state.data,
                         addr_prep.coordinates, self.keys.atk_glwe)

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
                                self.keys.atk_glwe, cache)
                for a0 in range(0, A, batch_slice)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    @torch.no_grad()
    def read_prepare_write(self, state: RamState,
                           addr_prep: address_mod.AddressPrepared):
        """Returns (read output, pending state).  The pending state shares
        its data tensor with `state`."""
        assert not state.pending, "pending write: call write() first"
        self._on_device("address", *addr_prep.coordinates)
        out, data, tree = rpw_impl(self.params, self.ctx, state.data,
                                   addr_prep.coordinates, self.keys.atk_glwe)
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
                              w, addr.coordinates, self.keys)
        return RamState(data=new_data, tree=(), pending=False)
