"""State carried across from the JAX package's client.

`from_reference` takes what that client produced, as numpy arrays (or
anything `np.asarray` accepts) -- the secret, the coefficient-domain
evaluation keys, the encrypted RAM, an address's coordinates, an
encrypted write word or a stack of them -- and returns this package's
objects on the asked device.  This package then
prepares keys and addresses with its own `prepare`: spectral forms are
never carried across, because each package defines its own spectrum
order.  With it, both packages compute the same read on the same
ciphertexts.  `stack_addresses` stacks addresses, prepared or in the
coefficient domain, into the batch layout of the batched read and the
batched read-modify-write.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .core.keys import EvaluationKeys
from .ops.ntt_cuda import require_device
from .ram.address import Address


@dataclass
class ReferenceState:
    """What `from_reference` was given, as this package's objects (None
    where nothing was given)."""

    sk: torch.Tensor | None          # int32[rank, N]
    keys: EvaluationKeys | None
    data: torch.Tensor | None        # int32[W, R, C, L, N]
    address: Address | None
    word: torch.Tensor | None = None  # int32[W, C, L, N]
    words: torch.Tensor | None = None  # int32[B, W, C, L, N]


def _tensor(x, device):
    return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def from_reference(sk=None, keys=None, ram=None, address=None, word=None,
                   words=None, device="cuda") -> ReferenceState:
    """sk: int32[rank, N]; keys: an object or dict with `atk_glwe`
    {g: [D, rank, C2, L, N]}, `atk_ggsw` {g: ...} and `tsk`; ram:
    int32[W, R, C, L, N]; address: an object with `coordinates` or the
    tuple of coordinate arrays itself; word: an encrypted write word
    int32[W, C, L, N]; words: a sequence of such words (or one array
    int32[B, W, C, L, N]), stacked for FheRam.rmw_batch."""
    device = require_device(device)
    out_keys = None
    if keys is not None:
        out_keys = EvaluationKeys(
            atk_glwe={int(g): _tensor(k, device)
                      for g, k in _field(keys, "atk_glwe").items()},
            atk_ggsw={int(g): _tensor(k, device)
                      for g, k in _field(keys, "atk_ggsw").items()},
            tsk=_tensor(_field(keys, "tsk"), device))
    out_addr = None
    if address is not None:
        coords = getattr(address, "coordinates", address)
        out_addr = Address(coordinates=tuple(_tensor(c, device) for c in coords))
    return ReferenceState(
        sk=None if sk is None else _tensor(sk, device),
        keys=out_keys,
        data=None if ram is None else _tensor(ram, device),
        address=out_addr,
        word=None if word is None else _tensor(word, device),
        words=None if words is None else _tensor(
            np.stack([np.asarray(w) for w in words]), device))


def stack_addresses(addrs) -> tuple:
    """A batch of addresses for FheRam.read_batch / rmw_batch: coordinate
    i of every address stacked on a new leading axis.  The addresses are
    all AddressPrepared objects (the prepared stacking) or all Address
    objects (the coefficient-domain stacking; rmw_batch takes both).
    Returns a tuple over coordinates."""
    addrs = list(addrs)
    if not addrs:
        raise ValueError("no address to stack")
    if len({type(a) for a in addrs}) != 1:
        raise ValueError("addresses of two kinds (prepared and not) in one stack")
    return tuple(torch.stack([a.coordinates[i] for a in addrs], dim=0)
                 for i in range(len(addrs[0].coordinates)))
