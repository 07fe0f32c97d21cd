"""The hand-written CUDA kernels of the encrypted read: their builder,
their wrappers, their launch counters, and beside each its plain PyTorch
version.

Counterpart of fhe_ram_tpu/ops/ntt_pallas.py.  Four kernels (csrc/):

  ntt_fwd_cuda / ntt_inv_cuda   the batched negacyclic NTT     (ntt.cu)
  fused_external_fold           external product / keyswitch   (fold.cu)
  fused_trace                   the whole trace chain          (trace.cu)
  fused_pack_merge              one pack-tree merge level      (pack_merge.cu)

Build: one `nvcc -shared` per source for sm_90a, all started together,
into `<package>/build/` at first use; plain C entry points bound with
ctypes.  Nothing is compiled when this module is imported.

Dispatch: a wrapper given a CUDA tensor launches its kernel or raises --
there is no fallback to the plain version when the build or the launch
fails.  Given a CPU tensor it runs the plain version.  `plain_versions()`
routes CUDA tensors through the plain versions too; it exists so that a
check can hold a kernel against its plain version on the same device,
and nothing on the serving path uses it.

Kernels launch on PyTorch's current stream, allocate nothing and do not
synchronise; outputs and scratch are `torch.empty` here.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import limb as limb_ops
from . import poly
from .crt import crt_fold, garner_consts
from .modular import I32, I64
from .ntt import NTTContext, ntt_fwd_plain, ntt_inv_plain

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"
SOURCES = ("ntt", "fold", "trace", "pack_merge")

_MAX_L = 8        # FHE_MAX_L of csrc/fhe_core.cuh
_MAX_STEPS = 16   # FHE_MAX_STEPS
_MAX_SMEM = 232448  # bytes of shared memory one block can use on sm_90
# Rows up to which a launch gives each row a cluster of 6 resp. 3 blocks
# (timed on an H100 with tools/time_fold_chunks.py: at T = 2, M = 6 a
# cluster of 6 wins up to 32 rows, of 3 up to 128, one block a row beyond).
_ROWS_CLUSTER_6 = 32
_ROWS_CLUSTER_3 = 128

# Kernel launches since the last reset_launches(): one count per wrapper,
# incremented where the wrapper launches its kernel and nowhere else.
LAUNCHES = {"ntt_fwd": 0, "ntt_inv": 0, "fused_external_fold": 0,
            "fused_trace": 0, "fused_pack_merge": 0}

_force_plain = False
_libs = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def plain_versions():
    """Route every wrapper through its plain version, whatever the
    device (verification only)."""
    global _force_plain
    old, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = old


# --------------------------------------------------------------------------
# build and bind
# --------------------------------------------------------------------------

class _Consts(ctypes.Structure):
    _fields_ = [("mu64", ctypes.c_uint64 * 3), ("p", ctypes.c_uint32 * 3),
                ("mu40", ctypes.c_uint32 * 3), ("c12", ctypes.c_uint32),
                ("p1m3", ctypes.c_uint32), ("c123", ctypes.c_uint32),
                ("log_n", ctypes.c_int)]


class _Tables(ctypes.Structure):
    _fields_ = [("psi", ctypes.c_void_p), ("inv_psi", ctypes.c_void_p),
                ("fwd_tw", ctypes.c_void_p), ("inv_tw", ctypes.c_void_p)]


class _FoldShape(ctypes.Structure):
    _fields_ = [("T", ctypes.c_int), ("M", ctypes.c_int), ("Lk", ctypes.c_int),
                ("Lout", ctypes.c_int), ("C2", ctypes.c_int),
                ("sign", ctypes.c_int), ("mc", ctypes.c_int),
                ("cs", ctypes.c_int)]


class _TraceSteps(ctypes.Structure):
    _fields_ = [("count", ctypes.c_int), ("ginv", ctypes.c_int * _MAX_STEPS)]


def _find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build_kernels(verbose: bool = False):
    """Compile csrc/*.cu into build/ (one nvcc per source, in parallel)
    and return {name: ctypes library}.  Raises on any compiler error."""
    nvcc = _find_nvcc()
    header = (_CSRC / "fhe_core.cuh").read_bytes()
    _BUILD.mkdir(exist_ok=True)
    jobs, paths = [], {}
    for name in SOURCES:
        src = _CSRC / f"{name}.cu"
        tag = hashlib.sha256(header + src.read_bytes()).hexdigest()[:16]
        so = _BUILD / f"libfhe_{name}_{tag}.so"
        paths[name] = so
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-I", str(_CSRC), "-o", str(tmp), str(src)]
        jobs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, so, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        if verbose:
            print(log)
        os.replace(tmp, so)

    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs = {name: ctypes.CDLL(str(path)) for name, path in paths.items()}
    sigs = {
        ("ntt", "fhe_ntt_fwd"): [vp, vp, ci, _Consts, _Tables, vp],
        ("ntt", "fhe_ntt_inv"): [vp, vp, ci, _Consts, _Tables, vp],
        ("fold", "fhe_fold"): [vp, vp, vp, vp, vp, ci, ci, _FoldShape,
                               _Consts, _Tables, vp],
        ("trace", "fhe_trace"): [vp, vp, vp, vp, vp, ci, _TraceSteps, ci,
                                 _FoldShape, _Consts, _Tables, vp],
        ("pack_merge", "fhe_pack_merge"): [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                           _FoldShape, _Consts, _Tables, vp],
    }
    for (lib, fn), argtypes in sigs.items():
        f = getattr(libs[lib], fn)
        f.argtypes = argtypes
        f.restype = ci
    return libs


def ensure_built(verbose: bool = False):
    """Build and load the kernels now (otherwise the first CUDA tensor
    that reaches a wrapper does it)."""
    global _libs
    if _libs is None:
        _libs = build_kernels(verbose)
    return _libs


def _lib(name: str):
    return ensure_built()[name]


def _consts(ctx: NTTContext) -> _Consts:
    if len(ctx.primes) != 3:
        raise ValueError("the CUDA kernels are wired for 3 primes")
    g = garner_consts(ctx.primes)
    c = _Consts()
    for i, p in enumerate(ctx.primes):
        if not (1 << 19) <= p < (1 << 20):
            raise ValueError(f"prime {p} outside the kernels' [2^19, 2^20) range")
        c.p[i] = p
        c.mu64[i] = (1 << 64) // p
        c.mu40[i] = (1 << 40) // p
    c.c12, c.p1m3, c.c123 = g["c12"], g["p1_mod_p3"], g["c123"]
    c.log_n = ctx.log_n
    return c


def _tables(ctx: NTTContext, device) -> _Tables:
    psi, inv_psi, fwd_tw, inv_tw = ctx.tables(device, I32)
    return _Tables(psi.data_ptr(), inv_psi.data_ptr(), fwd_tw.data_ptr(),
                   inv_tw.data_ptr())


def require_device(device) -> torch.device:
    """The device an entry point was asked for, or an error: a CUDA
    device that is not there is never replaced by the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but no CUDA device is available; "
            "pass device='cpu' explicitly to run the plain versions")
    return device


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with error {err}")


def _require(t, name: str, shape=None):
    if t.dtype != I32:
        raise TypeError(f"{name}: int32 expected, got {t.dtype}")
    if not t.is_cuda:
        raise ValueError(f"{name}: CUDA tensor expected, got {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    return t.contiguous()


def _use_kernel(ctx: NTTContext, t) -> bool:
    """True: launch the kernel.  False: the plain version (CPU tensor, or
    plain_versions()).  A CUDA tensor the kernels do not take raises."""
    if _force_plain or not t.is_cuda:
        return False
    if ctx.n != 4096:
        raise ValueError(f"the CUDA kernels take n = 4096, got n = {ctx.n}")
    return True


def _fold_limits(T: int, M: int, c2: int, out_limbs: int, n: int):
    if M % c2 != 0:
        raise ValueError(f"M = {M} is not a multiple of c2 = {c2}")
    if out_limbs > _MAX_L:
        raise ValueError(f"out_limbs = {out_limbs} > {_MAX_L}")
    if (T + 1) * 4 * n > _MAX_SMEM:
        raise ValueError(f"T = {T} digit polys do not fit one block's shared memory")


# (mc, cs) forced by tools/time_fold_chunks.py when it times the choices;
# None everywhere else.
SHAPE_OVERRIDE = None


def _fold_shape(rows: int, T: int, M: int, c2: int, out_limbs: int, sign: int,
                n: int) -> _FoldShape:
    """The kernels' shape argument, with the two launch choices:

    cs  blocks that share one row.  A single row keeps one SM busy for
        ~0.45 ms, so launches with few rows spread each row over a thread
        block cluster: 3 blocks (one per prime) or 6 (the output polys
        halved as well).  With enough rows to fill the card, one block a
        row does the least redundant work.
    mc  output polys that share one inverse-transform pass; shared memory
        is (T + mc) polys a block."""
    if rows <= _ROWS_CLUSTER_6 and M % 2 == 0:
        cs = 6
    elif rows <= _ROWS_CLUSTER_3:
        cs = 3
    else:
        cs = 1
    mc = 3
    if SHAPE_OVERRIDE is not None:
        mc, cs = SHAPE_OVERRIDE
    m_block = M // (cs // 3) if cs > 1 else M
    mc = max(1, min(mc, m_block, _MAX_SMEM // (4 * n) - T))
    return _FoldShape(T, M, M // c2, out_limbs, c2, -1 if sign < 0 else 1, mc, cs)


# --------------------------------------------------------------------------
# kernel 1: the NTT
# --------------------------------------------------------------------------

def ntt_fwd_cuda(ctx: NTTContext, x):
    """Forward NTT, int32[..., N] -> int32[P, ..., N] canonical residues.
    Plain version: ops.ntt.ntt_fwd_plain."""
    if not _use_kernel(ctx, x):
        return ntt_fwd_plain(ctx, x)
    n = ctx.n
    P = len(ctx.primes)
    lead = tuple(x.shape[:-1])
    x2 = _require(x.reshape(-1, n), "x")
    B = x2.shape[0]
    out = torch.empty((P, B, n), dtype=I32, device=x.device)
    if B:
        fn = _lib("ntt").fhe_ntt_fwd
        with torch.cuda.device(x.device):
            err = fn(x2.data_ptr(), out.data_ptr(), B, _consts(ctx),
                     _tables(ctx, x.device), _stream())
        _check(err, "ntt_fwd")
        LAUNCHES["ntt_fwd"] += 1
    return out.reshape((P,) + lead + (n,))


def ntt_inv_cuda(ctx: NTTContext, x):
    """Inverse NTT, int32[P, ..., N] -> centered residues int32[P, ..., N].
    Plain version: ops.ntt.ntt_inv_plain."""
    if not _use_kernel(ctx, x):
        return ntt_inv_plain(ctx, x)
    n = ctx.n
    P = len(ctx.primes)
    shape = tuple(x.shape)
    x2 = _require(x.reshape(P, -1, n), "x")
    B = x2.shape[1]
    out = torch.empty((P, B, n), dtype=I32, device=x.device)
    if B:
        fn = _lib("ntt").fhe_ntt_inv
        with torch.cuda.device(x.device):
            err = fn(x2.data_ptr(), out.data_ptr(), B, _consts(ctx),
                     _tables(ctx, x.device), _stream())
        _check(err, "ntt_inv")
        LAUNCHES["ntt_inv"] += 1
    return out.reshape(shape)


# --------------------------------------------------------------------------
# kernel 2: external product / keyswitch fold
# --------------------------------------------------------------------------

def fused_external_fold_plain(ctx: NTTContext, x, keys_ntt, out_limbs: int,
                              c2: int, base=None, sign: int = 1):
    """Plain version of `fused_external_fold`: the composed path (forward
    NTT, int64 products, inverse NTT, crt_fold, normalize)."""
    P, digits, T, M, n = keys_ntt.shape
    Lk = M // c2
    p = ctx.consts(4, x.device)
    for d in range(digits):
        B = x.shape[0]
        spec = ntt_fwd_plain(ctx, x).to(I64)          # [P, B, T, N]
        acc = torch.zeros((P, B, M, n), dtype=I64, device=x.device)
        for t in range(T):
            acc = acc + spec[:, :, t, None, :] * keys_ntt[:, d, t][:, None].to(I64)
        conv = ntt_inv_plain(ctx, torch.remainder(acc, p).to(I32))
        out = crt_fold(ctx.primes, conv.reshape(P, B, c2, Lk, n), 17, out_limbs)
        if sign < 0:
            out = -out
        if base is not None:
            out = base + out
        out = limb_ops.normalize(out)                 # [B, c2, Lout, N]
        x = out.reshape(B, c2 * out_limbs, n)
    return out


def fused_external_fold(ctx: NTTContext, x, keys_ntt, out_limbs: int, c2: int,
                        base=None, sign: int = 1):
    """External product / keyswitch including the exact CRT fold and the
    carry normalize, one launch.

    x: int32[B, T, N] gadget digits (coefficient domain, any int32).
    keys_ntt: int32[P, digits, T, M, N] prepared key rows, M = c2*Lk,
      row-major over (c2, key limb); digits > 1 chains a CMux digit chain
      (requires T == c2*out_limbs and no base).
    base: optional int32[B, c2, out_limbs, N]:
      out = normalize(base + sign * fold).
    Returns int32[B, c2, out_limbs, N] normalized."""
    P, digits, T, M, n = keys_ntt.shape
    B = x.shape[0]
    if tuple(x.shape) != (B, T, n) or n != ctx.n or P != len(ctx.primes):
        raise ValueError(f"x {tuple(x.shape)} does not fit keys {tuple(keys_ntt.shape)}")
    if digits > 1 and (T != c2 * out_limbs or base is not None):
        raise ValueError("chained digits need T == c2*out_limbs and no base")
    _fold_limits(T, M, c2, out_limbs, n)
    if not _use_kernel(ctx, x):
        return fused_external_fold_plain(ctx, x, keys_ntt, out_limbs, c2, base, sign)
    x = _require(x, "x")
    keys_ntt = _require(keys_ntt, "keys_ntt")
    if base is not None:
        base = _require(base, "base", (B, c2, out_limbs, n))
    out = torch.empty((B, c2, out_limbs, n), dtype=I32, device=x.device)
    if B == 0:
        return out
    scratch = torch.empty((B, P, M, n), dtype=I32, device=x.device)
    sh = _fold_shape(B, T, M, c2, out_limbs, sign, n)
    with torch.cuda.device(x.device):
        err = _lib("fold").fhe_fold(
            x.data_ptr(), keys_ntt.data_ptr(),
            None if base is None else base.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, digits, sh, _consts(ctx),
            _tables(ctx, x.device), _stream())
    _check(err, "fused_external_fold")
    LAUNCHES["fused_external_fold"] += 1
    return out


# --------------------------------------------------------------------------
# kernel 3: the trace chain
# --------------------------------------------------------------------------

def _trace_step_plain(ctx, ct, key, g, Td):
    """normalize(ct + KS(sigma_g(ct))) for one prepared key [P, T, M, N]."""
    B, C2, L, n = ct.shape
    rank = C2 - 1
    sa = poly.automorphism(ct, g)
    x = sa[:, :rank, :Td].reshape(B, rank * Td, n)
    base = ct.clone()
    base[:, rank] += sa[:, rank]
    return fused_external_fold_plain(ctx, x, key[:, None], L, C2, base=base,
                                     sign=-1)


def fused_trace_plain(ctx: NTTContext, ct, keys_stacked, gal_els):
    S, P, T, M, n = keys_stacked.shape
    C2 = ct.shape[1]
    Td = T // (C2 - 1)
    for s, g in enumerate(gal_els):
        ct = _trace_step_plain(ctx, ct, keys_stacked[s], g, Td)
    return ct


def fused_trace(ctx: NTTContext, ct, keys_stacked, gal_els):
    """The whole normalized-trace chain in one launch.

    ct: int32[B, C2, L, N] normalized; keys_stacked: int32[S, P, T, M, N]
    prepared automorphism keys (T = rank*Td, Td <= L the decomposed digits;
    M = C2*Lk); gal_els: the S galois elements.  Returns int32[B, C2, L, N]
    == the chain ct <- normalize(ct + KS(sigma_g(ct)))."""
    B, C2, L, n = ct.shape
    S, P, T, M, n3 = keys_stacked.shape
    rank = C2 - 1
    if n != ctx.n or n3 != n or T % rank or M % C2 or T // rank > L:
        raise ValueError(f"ct {tuple(ct.shape)} does not fit keys {tuple(keys_stacked.shape)}")
    if S != len(gal_els) or not 1 <= S <= _MAX_STEPS:
        raise ValueError(f"{S} steps: one launch chains 1..{_MAX_STEPS}")
    _fold_limits(T, M, C2, L, n)
    if not _use_kernel(ctx, ct):
        return fused_trace_plain(ctx, ct, keys_stacked, gal_els)
    ct = _require(ct, "ct")
    keys_stacked = _require(keys_stacked, "keys_stacked")
    out = torch.empty_like(ct)
    if B == 0:
        return out
    tmp = torch.empty_like(ct)
    scratch = torch.empty((B, P, M, n), dtype=I32, device=ct.device)
    steps = _TraceSteps()
    steps.count = S
    for s, g in enumerate(gal_els):
        steps.ginv[s] = poly.auto_inverse(n, g)
    sh = _fold_shape(B, T, M, C2, L, -1, n)
    with torch.cuda.device(ct.device):
        err = _lib("trace").fhe_trace(
            ct.data_ptr(), keys_stacked.data_ptr(), out.data_ptr(),
            tmp.data_ptr(), scratch.data_ptr(), B, steps, T // rank, sh,
            _consts(ctx), _tables(ctx, ct.device), _stream())
    _check(err, "fused_trace")
    LAUNCHES["fused_trace"] += 1
    return out


# --------------------------------------------------------------------------
# kernel 4: one pack-tree merge level
# --------------------------------------------------------------------------

def fused_pack_merge_plain(ctx: NTTContext, A, B, t_rot: int, g: int, key_ntt):
    P, T, M, n = key_ntt.shape
    nb, C2, L, _ = A.shape
    rank = C2 - 1
    Td = T // rank
    xb = poly.rotate(B, t_rot)
    u = A + xb
    sv = poly.automorphism(A - xb, g)
    x = sv[:, :rank, :Td].reshape(nb, rank * Td, n)
    base = u.clone()
    base[:, rank] += sv[:, rank]
    return fused_external_fold_plain(ctx, x, key_ntt[:, None], L, C2,
                                     base=base, sign=-1)


def fused_pack_merge(ctx: NTTContext, A, B, t_rot: int, g: int, key_ntt):
    """One pack-tree merge level with all glue in the kernel:

        out = normalize(u + KS(sigma_g(v))),  u/v = A +- X^t B

    A, B: int32[nb, C2, L, N] (limbs up to 2^17 in magnitude: the first
    level takes the pre-shifted, unnormalized rows); key_ntt: int32[P, T,
    M, N] (T = rank*Td, M = C2*Lk).  Returns int32[nb, C2, L, N]."""
    nb, C2, L, n = A.shape
    P, T, M, n3 = key_ntt.shape
    rank = C2 - 1
    if (tuple(B.shape) != tuple(A.shape) or n != ctx.n or n3 != n or T % rank
            or M % C2 or T // rank > L):
        raise ValueError(f"A {tuple(A.shape)}, B {tuple(B.shape)} do not fit key {tuple(key_ntt.shape)}")
    _fold_limits(T, M, C2, L, n)
    if not _use_kernel(ctx, A):
        return fused_pack_merge_plain(ctx, A, B, t_rot, g, key_ntt)
    A = _require(A, "A")
    B = _require(B, "B")
    key_ntt = _require(key_ntt, "key_ntt")
    out = torch.empty_like(A)
    if nb == 0:
        return out
    scratch = torch.empty((nb, P, M, n), dtype=I32, device=A.device)
    sh = _fold_shape(nb, T, M, C2, L, -1, n)
    with torch.cuda.device(A.device):
        err = _lib("pack_merge").fhe_pack_merge(
            A.data_ptr(), B.data_ptr(), key_ntt.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), nb, t_rot % (2 * n), poly.auto_inverse(n, g),
            T // rank, sh, _consts(ctx), _tables(ctx, A.device), _stream())
    _check(err, "fused_pack_merge")
    LAUNCHES["fused_pack_merge"] += 1
    return out
