"""State carried across from the JAX package's client.

`from_reference` takes what that client produced, as numpy arrays (or
anything `np.asarray` accepts) -- the secret, the coefficient-domain
evaluation keys, the encrypted RAM, an address's coordinates, an
encrypted write word or a stack of them, the VM's operands, the LOAD's
bootstrapping key -- and returns
this package's objects on the asked device.  This package then
prepares keys and addresses with its own `prepare`: spectral forms are
not carried across, because each package defines its own spectrum
order.  The one exception is the VM's prepared bits, which the JAX
client hands out only in spectral form (`fheuint.encrypt_prepared`): its
default transform (the butterfly one, every CPU run) has this package's
spectrum order with balanced residues, so they are carried across reduced
to canonical residues; spectra of its TPU kernels are not of that order
and must not be passed.  With it, both packages compute the same read and
the same VM cycle on the same ciphertexts.  `stack_addresses` stacks addresses, prepared or in the
coefficient domain, into the batch layout of the batched read and the
batched read-modify-write.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .core.keys import EvaluationKeys
from .params import DEFAULT_PRIMES
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
    vm: dict | None = None             # name -> word [C, L, N] or prepared bits
    bsk: torch.Tensor | None = None    # [rank*N, 2*D*C*C2*Lg, N] or [rank*N, 2, D, C, C2, Lg, N]


def _tensor(x, device):
    return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _prepared_bits(x, device, primes):
    """The JAX client's prepared bits [P, W, D, C, C2, Lg, N] (its default
    transform's spectra) as this package's canonical residues."""
    x = np.asarray(x, dtype=np.int64)
    if x.ndim != 7 or x.shape[0] != len(primes):
        raise ValueError(f"prepared bits [P, W, D, C, C2, Lg, N] expected, "
                         f"got {x.shape}")
    p = np.asarray(primes, dtype=np.int64).reshape((-1,) + (1,) * 6)
    return _tensor(np.mod(x, p).astype(np.int32), device)


def from_reference(sk=None, keys=None, ram=None, address=None, word=None,
                   words=None, vm=None, bsk=None, device="cuda") -> ReferenceState:
    """sk: int32[rank, N]; keys: an object or dict with `atk_glwe`
    {g: [D, rank, C2, L, N]}, `atk_ggsw` {g: ...} and `tsk`; ram:
    int32[W, R, C, L, N]; address: an object with `coordinates` or the
    tuple of coordinate arrays itself; word: an encrypted write word
    int32[W, C, L, N]; words: a sequence of such words (or one array
    int32[B, W, C, L, N]), stacked for FheRam.rmw_batch; vm: the VM
    operands by name, each a word-form GLWE [C, L, N] (`encrypt_word`) or
    prepared bits [P, W, D, C, C2, Lg, N] (`encrypt_prepared`, the
    pointer's too) of the JAX client's default transform over the presets'
    primes; bsk: the LOAD's bootstrapping key in a coefficient form,
    flat [rank*N, 2*D*C*C2*Lg, N] (`bootstrap_key_fast`) or 7-D
    [rank*N, 2, D, C, C2, Lg, N] (`bootstrap_key(prepared=False)`), kept in
    the form given."""
    device = require_device(device)
    if bsk is not None and np.ndim(bsk) not in (3, 7):
        raise ValueError(f"a coefficient bootstrapping key is 3-D or 7-D, got "
                         f"{np.shape(bsk)}")
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
            np.stack([np.asarray(w) for w in words]), device),
        vm=None if vm is None else {
            name: (_prepared_bits(x, device, DEFAULT_PRIMES) if np.ndim(x) == 7
                   else _tensor(x, device))
            for name, x in vm.items()},
        bsk=None if bsk is None else _tensor(bsk, device))


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
