"""The FHE-RAM engine: the encrypted read.

  * all WORDSIZE subrams are batched into one leading axis;
  * per-row CMux external products are batched over the row axis;
  * packing is the log-depth batched tree (core/packer.py);
  * state is explicit: a RamState in, ciphertexts out.

State layout:
  data: int32[W, R, C, L, N]      (W subrams, R = ceil(max_addr/N) rows)
  tree: tuple of int32[W, R_i, C, L, N]  (persistent packing levels,
        empty outside a pending write)

The write path (read_prepare_write / write) is not in this package yet;
`RamState.pending` and the guard in `FheRam.read` are kept so that its
protocol can be added without changing the read's callers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..params import Params
from ..ops.ntt import NTTContext, get_ntt_context
from ..ops import ntt_cuda
from ..core import glwe, keyswitch, packer, rng
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


# --------------------------------------------------------------------------
# server side: the read
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
    to run the plain versions, as the tests do)."""

    def __init__(self, params: Params,
                 keys_prepared: keys_mod.EvaluationKeysPrepared,
                 device="cuda"):
        self.params = params
        self.device = ntt_cuda.require_device(device)
        self.ctx = get_ntt_context(params.n, params.primes)
        self.keys = keys_prepared
        for g, k in keys_prepared.atk_glwe.items():
            if k.device.type != self.device.type:
                raise ValueError(
                    f"trace key g={g} lies on {k.device}, server on {self.device}")

    def init_state(self, data) -> RamState:
        """Wrap freshly encrypted RAM data (ram.encrypt_ram output)."""
        if data.device.type != self.device.type:
            raise ValueError(f"RAM data lies on {data.device}, server on {self.device}")
        return RamState(data=data, tree=(), pending=False)

    @torch.no_grad()
    def read(self, state: RamState, addr_prep: address_mod.AddressPrepared):
        assert not state.pending, "pending write: call write() first"
        return read_impl(self.params, self.ctx, state.data,
                         addr_prep.coordinates, self.keys.atk_glwe)
