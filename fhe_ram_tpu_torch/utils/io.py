"""Serialization of keys, addresses, and RAM state (checkpoint/resume).

A single .npz per object, int32 arrays, with a manifest entry recording
the Params so loads can be validated.  The format is the JAX package's
(same entry names, same manifest): a file written by either package loads
in the other.  Arrays are saved from whatever device they lie on and
loaded onto the device asked for.
"""

from __future__ import annotations

import json
from dataclasses import asdict

import numpy as np
import torch

from ..params import Params
from ..core.keys import EvaluationKeys
from ..ops.ntt_cuda import require_device
from ..ram.address import Address


def _params_json(params: Params) -> str:
    return json.dumps(asdict(params), sort_keys=True)


def _check_params(meta, params: Params):
    if params is not None and json.loads(meta) != json.loads(_params_json(params)):
        raise ValueError("checkpoint was written with different Params")


def _np(t):
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _tensor(a, device):
    return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)


def save_keys(path: str, params: Params, keys: EvaluationKeys):
    arrays = {f"atk_{g}": _np(v) for g, v in keys.atk_glwe.items()}
    arrays.update({f"atkg_{g}": _np(v) for g, v in keys.atk_ggsw.items()})
    arrays["tsk"] = _np(keys.tsk)
    np.savez_compressed(path, __params__=_params_json(params), **arrays)


def load_keys(path: str, params: Params | None = None,
              device="cuda") -> EvaluationKeys:
    device = require_device(device)
    z = np.load(path, allow_pickle=False)
    _check_params(str(z["__params__"]), params)
    atk, atk_ggsw = {}, {}
    for k in z.files:
        if k.startswith("atkg_"):
            atk_ggsw[int(k[5:])] = _tensor(z[k], device)
        elif k.startswith("atk_"):
            atk[int(k[4:])] = _tensor(z[k], device)
    return EvaluationKeys(atk_glwe=atk, atk_ggsw=atk_ggsw,
                          tsk=_tensor(z["tsk"], device))


def save_ram_state(path: str, params: Params, data, tree=()):
    arrays = {"data": _np(data)}
    for i, t in enumerate(tree):
        arrays[f"tree_{i}"] = _np(t)
    np.savez_compressed(path, __params__=_params_json(params),
                        __tree_levels__=len(tree), **arrays)


def load_ram_state(path: str, params: Params | None = None, device="cuda"):
    """Returns (data, tree): a pending state's tree levels, or ()."""
    device = require_device(device)
    z = np.load(path, allow_pickle=False)
    _check_params(str(z["__params__"]), params)
    levels = int(z["__tree_levels__"])
    data = _tensor(z["data"], device)
    tree = tuple(_tensor(z[f"tree_{i}"], device) for i in range(levels))
    return data, tree


def save_address(path: str, params: Params, addr: Address):
    arrays = {f"coord_{i}": _np(c) for i, c in enumerate(addr.coordinates)}
    np.savez_compressed(path, __params__=_params_json(params),
                        __n2__=len(addr.coordinates), **arrays)


def load_address(path: str, params: Params | None = None,
                 device="cuda") -> Address:
    device = require_device(device)
    z = np.load(path, allow_pickle=False)
    _check_params(str(z["__params__"]), params)
    n2 = int(z["__n2__"])
    return Address(coordinates=tuple(_tensor(z[f"coord_{i}"], device)
                                     for i in range(n2)))
