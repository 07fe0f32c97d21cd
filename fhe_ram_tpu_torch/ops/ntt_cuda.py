"""The hand-written CUDA kernels of the encrypted RAM: their build,
their wrappers, their launch counters, and beside each its plain PyTorch
version.

Counterpart of fhe_ram_tpu/ops/ntt_pallas.py.  Twelve kernels (csrc/):

  ntt_fwd_cuda / ntt_inv_cuda   the batched negacyclic NTT     (ntt.cu)
  fused_external_fold           external product / keyswitch   (fold.cu)
  fused_external_fold_batched   the same with per-item keys    (fold.cu)
  fused_external                the product without the fold   (external.cu)
  fused_trace                   the whole trace chain          (trace.cu)
  fused_pack_merge              one pack-tree merge level      (pack_merge.cu)
  fused_split                   one split-tree level           (split.cu)
  fused_split_tree              all split-tree levels          (split_tree.cu)
  fused_pack_tree               a whole pack tree              (pack_tree.cu)
  fused_blind_rotate            a blind-rotation CMux chain    (blind_rotate.cu)
  fused_dp_chain                the VM's carry-DP chain        (dp_chain.cu)
  fused_bitwise                 the VM's bitwise group         (bitwise.cu)

and the two collectives of the row-sharded pack, whose wrappers live in
parallel/collective.py (collective.cu): ring_all_gather, exchange.

Transform bodies: every source is built once.  The transforms of every
kernel but the collectives are the fold body's (three radix-16 passes in
registers, csrc/fold_body.cuh), so ntt.cu (kernel 1), fold.cu (kernels 2
and 5) and external.cu (kernel 12, on no path) serve the radix-2 and the
two-pass contexts (ops/ntt.py) with the same integers and count under
their own names whatever the context's body.
The fused kernels 3, 4 and 6-11 serve the radix-2 context only: a two-pass
context routes around them (ops.ntt.fused_path_active), and their wrappers
refuse it, the plain versions' route too.  Helpers that build the trace
step, the split level and the pack merge from one fold (trace_step,
split_level, pack_merge_level) serve the composed routes with the fold
kernel and the plain versions with its plain version.

Build: one `nvcc -shared` per source for sm_90a, all started
together, into `<package>/build/` at first use; plain C entry points bound
with ctypes.  Nothing is compiled when this module is imported.

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
import re
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
SOURCES = ("ntt", "fold", "external", "trace", "pack_merge", "split",
           "split_tree", "pack_tree", "blind_rotate", "dp_chain", "bitwise",
           "collective")

_MAX_L = 8        # FHE_MAX_L of csrc/fhe_core.cuh
_MAX_STEPS = 16   # FHE_MAX_STEPS: steps of a trace launch, levels of a tree launch
_MAX_OPS = 16     # FHE_MAX_OPS of csrc/dp_chain.cu, bitwise.cu: ops of a VM group
MAX_SHARDS = 16   # FHE_MAX_SHARDS of csrc/collective.cu: shards of a collective
_MAX_SMEM = 232448  # bytes of shared memory one block can use on sm_90
_SM_SMEM = 233472   # bytes of shared memory of an SM, 1 KB a block reserved
# Rows up to which a launch of the fold_row kernels (the pack tree, and the
# predecessors in tools/) gives each row a cluster of 6 resp. 3 blocks
# (timed on an H100 with tools/time_fold_chunks.py: at T = 2, M = 6 a
# cluster of 6 wins up to 32 rows, of 3 up to 128, one block a row beyond).
_ROWS_CLUSTER_6 = 32
_ROWS_CLUSTER_3 = 128
# The fold (csrc/fold.cu) and the kernels on its body (pack_merge.cu,
# trace.cu, split.cu, split_tree.cu, bitwise.cu, blind_rotate.cu,
# dp_chain.cu) give every row a cluster of 3 blocks, one a prime, or
# of 6 (the output components shared by two groups of 3) up to this many
# rows; tools/time_fold_predecessor.py times both.
_FOLD_ROWS_6 = 32
# Most clusters a launch on the fold body starts; with more rows than this
# each walks over several (the 2^24 level 0: 16,384 rows).
_MAX_ROW_GROUPS = 1024
_FOLD_MAX_LK = 8  # FOLD_MAX_LK of csrc/fold.cu: key limbs a fold takes

# Kernel launches since the last reset_launches(): one count per wrapper,
# incremented where the wrapper launches its kernel and nowhere else.
LAUNCHES = dict.fromkeys(
    ("ntt_fwd", "ntt_inv", "fused_external", "fused_external_fold",
     "fused_external_fold_batched", "fused_trace", "fused_pack_merge",
     "fused_split", "fused_split_tree", "fused_pack_tree", "fused_blind_rotate",
     "fused_dp_chain", "fused_bitwise", "ring_all_gather", "exchange"), 0)

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
    """csrc/fhe_core.cuh's FheTables, of the predecessors in tools/."""
    _fields_ = [("psi", ctypes.c_void_p), ("inv_psi", ctypes.c_void_p),
                ("fwd_tw", ctypes.c_void_p), ("inv_tw", ctypes.c_void_p)]


class _FoldShape(ctypes.Structure):
    _fields_ = [("T", ctypes.c_int), ("M", ctypes.c_int), ("Lk", ctypes.c_int),
                ("Lout", ctypes.c_int), ("C2", ctypes.c_int),
                ("sign", ctypes.c_int), ("mc", ctypes.c_int),
                ("cs", ctypes.c_int)]


class _FoldTables(ctypes.Structure):
    """csrc/fold.cu's FoldTables: pointers into NTTContext.shoup_tables."""
    _fields_ = [(name, ctypes.c_void_p) for name, _ in NTTContext.SHOUP_TABLES] + [
        ("garner", ctypes.c_void_p)]


class _TraceSteps(ctypes.Structure):
    _fields_ = [("count", ctypes.c_int), ("ginv", ctypes.c_int * _MAX_STEPS)]


class _PackLevels(ctypes.Structure):
    _fields_ = [("count", ctypes.c_int), ("ginv", ctypes.c_int * _MAX_STEPS),
                ("rot", ctypes.c_int * _MAX_STEPS)]


class _TreeLevels(ctypes.Structure):
    """fhe_core.cuh's TreeLevels, the pack tree's predecessor's level table
    (tools/)."""
    _fields_ = [("count", ctypes.c_int), ("cs", ctypes.c_int * _MAX_STEPS),
                ("ginv", ctypes.c_int * _MAX_STEPS),
                ("rot", ctypes.c_int * _MAX_STEPS)]


class _SplitLevels(ctypes.Structure):
    _fields_ = [("count", ctypes.c_int), ("ginv", ctypes.c_int * _MAX_STEPS),
                ("t_back", ctypes.c_int * _MAX_STEPS)]


class _RotSteps(ctypes.Structure):
    _fields_ = [("count", ctypes.c_int), ("rot", ctypes.c_int * _MAX_STEPS)]


class _DpTables(ctypes.Structure):
    _fields_ = [("count", ctypes.c_int), ("group", ctypes.c_int * _MAX_OPS),
                ("leaf", ctypes.c_ubyte * (_MAX_OPS * 2 * 4))]


class _OpGroups(ctypes.Structure):
    _fields_ = [("count", ctypes.c_int), ("group", ctypes.c_int * _MAX_OPS)]


class ShardPtrs(ctypes.Structure):
    """csrc/collective.cu's pointer table: one input and one output
    pointer a shard."""
    _fields_ = [("inp", ctypes.c_void_p * MAX_SHARDS),
                ("out", ctypes.c_void_p * MAX_SHARDS)]


def _find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def source_text(src: Path) -> bytes:
    """The bytes of a CUDA source and of every header it includes with
    `#include "..."`, directly or not (looked up beside the including file,
    then in csrc/): what a build's content hash covers."""
    out, seen, todo = [], set(), [Path(src)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        out.append(text)
        for inc in re.findall(rb'#include "([^"]+)"', text):
            near = path.parent / inc.decode()
            todo.append(near if near.exists() else _CSRC / inc.decode())
    return b"".join(out)


def start_build(src: Path, stem: str, flags=()):
    """Start `nvcc` on src (sm_90a, -Xptxas -v) into build/libfhe_<stem>_<tag>.so,
    the tag a hash of source_text(src) and the flags.  Returns (so, job):
    job is None when that library is built already, else (tmp, process)
    for finish_build."""
    tag = hashlib.sha256(source_text(src) + " ".join(flags).encode()).hexdigest()[:16]
    _BUILD.mkdir(exist_ok=True)
    so = _BUILD / f"libfhe_{stem}_{tag}.so"
    if so.exists():
        return so, None
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           *flags, "-I", str(_CSRC), "-o", str(tmp), str(src)]
    return so, (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))


def finish_build(what: str, so: Path, job, verbose: bool = False):
    """Wait for a start_build job; raise with nvcc's log if it failed."""
    if job is None:
        return
    tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what}:\n{log}")
    if verbose:
        print(f"{what}:\n{log}")
    os.replace(tmp, so)


def build_kernels(verbose: bool = False):
    """Compile csrc/*.cu into build/ (one nvcc per source, in parallel) and
    return {name: ctypes library}.  Raises on any compiler error."""
    _find_nvcc()
    jobs = {name: start_build(_CSRC / f"{name}.cu", name) for name in SOURCES}
    for name, (so, job) in jobs.items():
        finish_build(f"csrc/{name}.cu", so, job, verbose)

    vp, ci, cip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    libs = {name: ctypes.CDLL(str(so)) for name, (so, _) in jobs.items()}
    sigs = {
        ("ntt", "fhe_ntt_fwd"): [vp, vp, ci, ci, _Consts, _FoldTables, vp],
        ("ntt", "fhe_ntt_inv"): [vp, vp, ci, ci, _Consts, _FoldTables, vp],
        ("fold", "fhe_fold"): [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, _FoldShape,
                               _Consts, _FoldTables, vp],
        ("external", "fhe_external"): [vp, vp, vp, ci, ci, ci, ci, ci, ci, _Consts,
                                       _FoldTables, vp],
        ("trace", "fhe_trace"): [vp, vp, vp, vp, ci, ci, _TraceSteps, ci, ci,
                                 _FoldShape, _Consts, _FoldTables, vp],
        ("pack_merge", "fhe_pack_merge"): [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                           _FoldShape, _Consts, _FoldTables, vp],
        ("split", "fhe_split"): [vp, vp, vp, vp, ci, ci, ci, ci, ci, _FoldShape,
                                 _Consts, _FoldTables, vp],
        ("split_tree", "fhe_split_tree_clusters"): [_FoldShape, ci, cip],
        ("split_tree", "fhe_split_tree"): [vp, vp, vp, vp, vp, ci, ci, _SplitLevels,
                                           ci, _FoldShape, _Consts, _FoldTables, vp],
        ("pack_tree", "fhe_pack_tree_clusters"): [_FoldShape, ci, cip],
        ("pack_tree", "fhe_pack_tree"): [vp, vp, vp, vp, vp, ci, ci, ci, ci, _PackLevels,
                                         ci, _FoldShape, _Consts, _FoldTables, vp],
        ("blind_rotate", "fhe_blind_rotate"): [vp, vp, vp, vp, ci, ci, _RotSteps,
                                               ci, ci, _FoldShape, _Consts,
                                               _FoldTables, vp],
        ("dp_chain", "fhe_dp_chain_clusters"): [_FoldShape, ci, cip],
        ("dp_chain", "fhe_dp_chain"): [vp, vp, vp, vp, vp, vp, ci, _DpTables, ci,
                                       ci, ci, ci, _FoldShape, _Consts,
                                       _FoldTables, vp],
        ("bitwise", "fhe_bitwise_clusters"): [_FoldShape, ci, cip],
        ("bitwise", "fhe_bitwise"): [vp, vp, vp, vp, vp, vp, vp, ci, _OpGroups, ci, ci,
                                     ci, ci, _FoldShape, _Consts, _FoldTables, vp],
        ("collective", "fhe_ring_all_gather"): [ShardPtrs, ci, ctypes.c_longlong,
                                                vp],
        ("collective", "fhe_exchange"): [ShardPtrs, ci, ci, ctypes.c_longlong, ci, vp],
    }
    for name, lib in libs.items():
        for (src, fn), argtypes in sigs.items():
            if src == name:
                f = getattr(lib, fn)
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
    """The predecessors' tables (tools/): canonical words, no Shoup pairs."""
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
    plain_versions()).  A CUDA tensor the kernels do not take raises, and
    so does a tensor that is not int32 on either route."""
    if t.dtype != I32:
        raise TypeError(f"int32 expected, got {t.dtype}")
    if _force_plain or not t.is_cuda:
        return False
    if ctx.n != 4096:
        raise ValueError(f"the CUDA kernels take n = 4096, got n = {ctx.n}")
    return True


def _require_radix2(ctx: NTTContext, name: str):
    """Kernels 3, 4 and 6-11 have the radix-2 body only (the JAX package
    asserts the MXU family in each): a two-pass context, whose routes are
    the composed ones, is refused on both routes, the kernel's and the
    plain version's, so that a composed route that strays onto one fails
    on the CPU too."""
    if ctx.body != "radix2":
        raise ValueError(f"{name} serves the radix-2 context only, got the "
                         f"{ctx.body} body: its composed route is one fold a step")


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


def _row_blocks(rows: int, M: int) -> int:
    """Blocks that share one row in a launch (or a tree level) of `rows`
    rows: 6, 3 or 1 (see _fold_shape)."""
    if rows <= _ROWS_CLUSTER_6 and M % 2 == 0:
        return 6
    return 3 if rows <= _ROWS_CLUSTER_3 else 1


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
    cs = _row_blocks(rows, M)
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
    lead = tuple(x.shape[:-1])
    out = _launch_ntt(ctx, "fwd", x.reshape(-1, n))
    if out.shape[1]:
        LAUNCHES["ntt_fwd"] += 1
    return out.reshape((len(ctx.primes),) + lead + (n,))


def ntt_inv_cuda(ctx: NTTContext, x):
    """Inverse NTT, int32[P, ..., N] -> centered residues int32[P, ..., N].
    Plain version: ops.ntt.ntt_inv_plain."""
    if not _use_kernel(ctx, x):
        return ntt_inv_plain(ctx, x)
    shape = tuple(x.shape)
    out = _launch_ntt(ctx, "inv", x.reshape(len(ctx.primes), -1, ctx.n))
    if out.shape[1]:
        LAUNCHES["ntt_inv"] += 1
    return out.reshape(shape)


def _launch_ntt(ctx: NTTContext, direction: str, x, blocks: int | None = None):
    """One launch of csrc/ntt.cu on x int32[B, N] ("fwd") or int32[P, B, N]
    ("inv"), not counted (the wrappers count it); returns int32[P, B, N].
    The same build serves every context's body.  One (polynomial, prime)
    item a block, and the instantiation (the blocks an SM its registers are
    budgeted for) by the items: 2 (up to 128 registers a thread) while they
    fit the card at two blocks an SM, else 4 (64).  On an H100 either was
    the faster there: 0.0092 against 0.0106 ms for the inverse at 36 polys,
    0.0628 against 0.0660 for the forward at 1024.  blocks given here
    overrides the choice (tools/time_pack_tree_ntt_predecessors.py times
    both)."""
    n = ctx.n
    P = len(ctx.primes)
    x = _require(x, "x")
    if direction == "inv":
        x = _aligned16(x)
    B = x.shape[-2]
    out = torch.empty((P, B, n), dtype=I32, device=x.device)
    if B:
        with torch.cuda.device(x.device):
            err = getattr(_lib("ntt"), f"fhe_ntt_{direction}")(
                x.data_ptr(), out.data_ptr(), B,
                blocks or (2 if P * B <= 2 * _sms(x.device) else 4),
                _consts(ctx), _fold_tables(ctx, x.device), _stream())
        _check(err, f"ntt_{direction}")
    return out


# --------------------------------------------------------------------------
# kernel 2: external product / keyswitch fold
# --------------------------------------------------------------------------

def fused_external_fold_plain(ctx: NTTContext, x, keys_ntt, out_limbs: int,
                              c2: int, base=None, sign: int = 1,
                              x_is_ntt: bool = False):
    """Plain version of `fused_external_fold`: the composed path (forward
    NTT unless the spectra are given, int64 products, inverse NTT,
    crt_fold, normalize)."""
    P, digits, T, M, n = keys_ntt.shape
    Lk = M // c2
    p = ctx.consts(4, x.device)
    for d in range(digits):
        if d == 0 and x_is_ntt:
            spec = torch.remainder(x.to(I64), p)      # canonical on load
        else:
            spec = ntt_fwd_plain(ctx, x).to(I64)      # [P, B, T, N]
        B = spec.shape[1]
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


def _fold_args(ctx: NTTContext, x, keys_ntt, out_limbs: int, c2: int, base,
               x_is_ntt: bool, batched: bool):
    """Check the arguments of the two fold wrappers against each other.
    keys_ntt: [P, digits, T, M, N], or batched [A, P, digits, T, M, N].
    Returns (A, B): items (1 without the batch axis) and rows an item."""
    kshape = tuple(keys_ntt.shape)
    A = kshape[0] if batched else 1
    P, digits, T, M, n = kshape[-5:]
    lead = (A,) if batched else ()
    if x_is_ntt:
        B = x.shape[1] if x.dim() == 4 else -1
        want = (P, B, T, n)
    else:
        B = x.shape[len(lead)] if x.dim() == len(lead) + 3 else -1
        want = lead + (B, T, n)
    if (len(kshape) != len(lead) + 5 or tuple(x.shape) != want or n != ctx.n
            or P != len(ctx.primes)):
        raise ValueError(f"x {tuple(x.shape)} (x_is_ntt={x_is_ntt}) does not "
                         f"fit keys {kshape}")
    if digits > 1 and (T != c2 * out_limbs or base is not None):
        raise ValueError("chained digits need T == c2*out_limbs and no base")
    if base is not None and tuple(base.shape) != lead + (B, c2, out_limbs, n):
        raise ValueError(f"base {tuple(base.shape)} != "
                         f"{lead + (B, c2, out_limbs, n)}")
    for name, t in (("keys_ntt", keys_ntt), ("base", base)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    _fold_limits(T, M, c2, out_limbs, n)
    # csrc/fold.cu keeps T spectra and the Lk residue polys of a component
    # in one block's shared memory
    if M // c2 > _FOLD_MAX_LK or (T + M // c2) * 4 * n > _MAX_SMEM:
        raise ValueError(f"T = {T} digit polys and {M // c2} key limbs do not fit "
                         "the fold's shared memory")
    return A, B


def _fold_cs(rows: int, c2: int) -> int:
    """Blocks of a fold cluster (csrc/fold.cu): 3, one a prime, or 6 (two
    groups of 3 that share the output components) while the rows are few
    and the components split evenly."""
    return 6 if rows <= _FOLD_ROWS_6 and c2 % 2 == 0 else 3


_sm_count = {}


def _sms(device) -> int:
    """The SMs of the card `device` names."""
    index = torch.device(device).index or 0
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_count[index]


def _fold_blocks(blocks_total: int, T: int, Lk: int, device) -> int:
    """The instantiation of csrc/fold.cu (or of a kernel on the same body:
    pack_merge.cu, trace.cu, split.cu, split_tree.cu, bitwise.cu,
    blind_rotate.cu, dp_chain.cu) a launch of `blocks_total` blocks
    takes: 2 (128 registers a thread, two blocks an SM) when the shape's
    shared memory, (T + Lk) polys a block, lets two blocks share an SM and
    there are more blocks than SMs; else 1
    (up to 255 registers: a launch that holds one block an SM anyway, or a
    short one, runs the single block faster)."""
    two_fit = 2 * ((T + Lk) * 4 * 4096 + 1024) <= _SM_SMEM
    return 2 if two_fit and blocks_total > _sms(device) else 1


def _fold_tables(ctx: NTTContext, device) -> _FoldTables:
    tab, offsets = ctx.shoup_tables(device)
    base = tab.data_ptr()
    return _FoldTables(*(base + 4 * offsets[name] for name, _ in _FoldTables._fields_))


def _aligned16(t):
    """t, or a copy of it whose data starts on 16 bytes (the kernels on the
    fold body load keys, spectra and staged rows 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fold_shape_arg(rows: int, T: int, M: int, c2: int, out_limbs: int,
                    sign: int) -> _FoldShape:
    """The shape argument of csrc/fold.cu and the kernels on its body (`mc`
    is not read there)."""
    return _FoldShape(T, M, M // c2, out_limbs, c2, -1 if sign < 0 else 1, 0,
                      _fold_cs(rows, c2))


def _staged_fold_polys(T: int, M: int, c2: int, what: str) -> int:
    """Polys of shared memory a block of every kernel on the fold body but
    fold.cu holds: the T spectra and max(Lk, 3) residue polys, the third
    doubling as the staging buffer of a digit poly.  Raises where they do
    not fit."""
    polys = T + max(M // c2, 3)
    if M // c2 > _FOLD_MAX_LK or polys * 4 * 4096 > _MAX_SMEM:
        raise ValueError(f"T = {T} digit polys and {M // c2} key limbs do not fit "
                         f"the {what}'s shared memory")
    return polys


def _launch_fold(wrapper: str, ctx: NTTContext, x, keys_ntt, out_limbs: int,
                 c2: int, base, sign: int, x_is_ntt: bool, A: int, B: int):
    """One launch of csrc/fold.cu over A * B rows for the wrapper named,
    counted as its launch; returns int32[A * B, c2, out_limbs, N]."""
    _, digits, T, M, n = keys_ntt.shape[-5:]
    rows = A * B
    x = _require(x, "x")
    keys_ntt = _aligned16(_require(keys_ntt, "keys_ntt"))
    if x_is_ntt:
        x = _aligned16(x)
    if base is not None:
        base = _require(base, "base")
    out = torch.empty((rows, c2, out_limbs, n), dtype=I32, device=x.device)
    if rows == 0:
        return out
    sh = _fold_shape_arg(rows, T, M, c2, out_limbs, sign)
    clusters = min(rows, _MAX_ROW_GROUPS)
    with torch.cuda.device(x.device):
        err = _lib("fold").fhe_fold(
            x.data_ptr(), keys_ntt.data_ptr(),
            None if base is None else base.data_ptr(), out.data_ptr(), rows, B,
            clusters, int(x_is_ntt), digits,
            _fold_blocks(clusters * sh.cs, T, M // c2, x.device), sh, _consts(ctx),
            _fold_tables(ctx, x.device), _stream())
    _check(err, wrapper)
    LAUNCHES[wrapper] += 1
    return out


def fused_external_fold(ctx: NTTContext, x, keys_ntt, out_limbs: int, c2: int,
                        base=None, sign: int = 1, x_is_ntt: bool = False):
    """External product / keyswitch including the exact CRT fold and the
    carry normalize, one launch.

    x: int32[B, T, N] gadget digits (coefficient domain, any int32), or
      with x_is_ntt int32[P, B, T, N] their spectra in this package's
      order (what `ntt_fwd_cuda` writes; any representative): the forward
      transform is skipped.
    keys_ntt: int32[P, digits, T, M, N] prepared key rows, M = c2*Lk,
      row-major over (c2, key limb); digits > 1 chains a CMux digit chain
      (requires T == c2*out_limbs and no base); with x_is_ntt digit 0
      consumes the spectra and the later digits transform the carry.
    base: optional int32[B, c2, out_limbs, N]:
      out = normalize(base + sign * fold).
    Returns int32[B, c2, out_limbs, N] normalized."""
    _, B = _fold_args(ctx, x, keys_ntt, out_limbs, c2, base, x_is_ntt, False)
    if not _use_kernel(ctx, x):
        return fused_external_fold_plain(ctx, x, keys_ntt, out_limbs, c2, base,
                                         sign, x_is_ntt)
    return _launch_fold("fused_external_fold", ctx, x, keys_ntt, out_limbs, c2,
                        base, sign, x_is_ntt, 1, B)


# --------------------------------------------------------------------------
# kernel 5: the fold with per-item keys
# --------------------------------------------------------------------------

def fused_external_fold_batched_plain(ctx: NTTContext, x, keys_ntt,
                                      out_limbs: int, c2: int,
                                      x_is_ntt: bool = False, base=None,
                                      sign: int = 1):
    """Plain version of `fused_external_fold_batched`: item by item
    through `fused_external_fold_plain`."""
    return torch.stack([
        fused_external_fold_plain(
            ctx, x if x_is_ntt else x[a], keys_ntt[a], out_limbs, c2,
            None if base is None else base[a], sign, x_is_ntt)
        for a in range(keys_ntt.shape[0])], dim=0)


def fused_external_fold_batched(ctx: NTTContext, x, keys_ntt, out_limbs: int,
                                c2: int, x_is_ntt: bool = False, base=None,
                                sign: int = 1):
    """`fused_external_fold` with per-item keys: item a of the leading
    batch axis goes against keys_ntt[a], all items in one launch.

    x: int32[A, B, T, N]; keys_ntt: int32[A, P, digits, T, M, N].  With
    x_is_ntt, x is int32[P, B, T, N]: ONE spectral operand shared by every
    item (a batched read's level 0: the RAM rows' transform is hoisted out
    of the address batch); digit 0 consumes it and later digits transform
    the carry.
    base: optional int32[A, B, c2, out_limbs, N]:
      out = normalize(base + sign * fold).
    Returns int32[A, B, c2, out_limbs, N] normalized; the residues stay on
    chip, so memory grows with the batch only through the output."""
    A, B = _fold_args(ctx, x, keys_ntt, out_limbs, c2, base, x_is_ntt, True)
    if not _use_kernel(ctx, x):
        return fused_external_fold_batched_plain(ctx, x, keys_ntt, out_limbs,
                                                 c2, x_is_ntt, base, sign)
    out = _launch_fold("fused_external_fold_batched", ctx, x, keys_ntt,
                       out_limbs, c2, base, sign, x_is_ntt, A, B)
    return out.reshape(A, B, c2, out_limbs, ctx.n)


# --------------------------------------------------------------------------
# kernel 12: the external product without the fold
# --------------------------------------------------------------------------

def fused_external_plain(ctx: NTTContext, x, keys_ntt):
    """Plain version of `fused_external`: forward NTT, int64 products summed
    over T, inverse NTT."""
    P, T, M, n = keys_ntt.shape
    spec = ntt_fwd_plain(ctx, x).to(I64)              # [P, B, T, N]
    acc = torch.zeros((P, x.shape[0], M, n), dtype=I64, device=x.device)
    for t in range(T):
        acc = acc + spec[:, :, t, None, :] * keys_ntt[:, t][:, None].to(I64)
    return ntt_inv_plain(ctx, torch.remainder(acc, ctx.consts(4, x.device)).to(I32))


def _external_launch(B: int, T: int, M: int, sms: int, split=None, blocks=None):
    """(split, blocks_total, blocks) of a launch of csrc/external.cu over B
    rows on a card of `sms` SMs: the units (row, prime) are cut into
    `split` parts of the M output polys while there are fewer units than
    SMs (each part redoes the row's T forward transforms), else kept
    whole; the instantiation `blocks` is 2 (128 registers a thread) where
    two blocks' shared memory, (T + 2) polys each, fits an SM and there are
    more units than SMs, else 1 (up to 255); at most one wave of persistent
    blocks.  Timed on an H100 (tools/time_external_exchange_predecessors.py,
    which times every choice): at B=2, T=3, M=2 a split of 2 at one block
    an SM ran 0.019 ms, unsplit 0.024 (0.021 / 0.026 at two blocks an SM);
    at B=256, T=4, M=6 unsplit at two blocks an SM 0.216, at one 0.245, a
    split of 6 0.49.  split and blocks given here override the choice."""
    if split is None:
        split = max(1, min(M, sms // (B * 3)))
    units = B * 3 * split
    if blocks is None:
        two_fit = 2 * ((T + 2) * 4 * 4096 + 1024) <= _SM_SMEM
        blocks = 2 if two_fit and units > sms else 1
    return split, min(units, blocks * sms), blocks


def _launch_external(ctx: NTTContext, x, keys_ntt, split=None, blocks=None):
    """One launch of csrc/external.cu, not counted (the wrapper counts it);
    returns int32[P, B, M, N].  The same build serves every context's
    body."""
    x = _require(x, "x")
    keys_ntt = _aligned16(_require(keys_ntt, "keys_ntt"))
    B, T, n = x.shape
    P, _, M, _ = keys_ntt.shape
    out = torch.empty((P, B, M, n), dtype=I32, device=x.device)
    if B:
        split, total, blocks = _external_launch(B, T, M, _sms(x.device), split, blocks)
        with torch.cuda.device(x.device):
            err = _lib("external").fhe_external(
                x.data_ptr(), keys_ntt.data_ptr(), out.data_ptr(), B, T, M, split, total,
                blocks, _consts(ctx), _fold_tables(ctx, x.device), _stream())
        _check(err, "fused_external")
    return out


def fused_external(ctx: NTTContext, x, keys_ntt):
    """The external product core in one launch, without the CRT fold:

        out[p, b, m] = sum_t x[b, t] (*) key[t, m]  mod prime p

    x: int32[B, T, N] gadget digits (coefficient domain, any int32);
    keys_ntt: int32[P, T, M, N] prepared key rows.  Returns int32[P, B, M, N]
    centered residues of the convolutions, for ops.crt.crt_fold.  On no
    path of the RAM (nor is its counterpart in the JAX package)."""
    B, T, n = x.shape
    P, T2, M, n2 = keys_ntt.shape
    if T2 != T or n2 != n or n != ctx.n or P != len(ctx.primes):
        raise ValueError(f"x {tuple(x.shape)} does not fit keys {tuple(keys_ntt.shape)}")
    if keys_ntt.device != x.device:
        raise ValueError(f"keys_ntt lies on {keys_ntt.device}, x on {x.device}")
    if (T + 2) * 4 * n > _MAX_SMEM:
        raise ValueError(f"T = {T} digit polys do not fit kernel 12's shared memory")
    if not _use_kernel(ctx, x):
        return fused_external_plain(ctx, x, keys_ntt)
    out = _launch_external(ctx, x, keys_ntt)
    if B:
        LAUNCHES["fused_external"] += 1
    return out


# --------------------------------------------------------------------------
# one fold and its glue: a trace step, a split level, a pack merge
# --------------------------------------------------------------------------
# `fold` is fused_external_fold (the composed routes: one launch of the fold
# kernel, the rest torch glue) or fused_external_fold_plain (the plain
# versions of the fused trace, split and merge kernels).

def trace_step(ctx: NTTContext, ct, key, g: int, Td: int, fold):
    """normalize(ct + KS(sigma_g(ct))) of rows ct [B, C2, L, N] against one
    prepared key [P, T, M, N] (T = rank * Td: the top Td limbs of the mask
    components are the digits)."""
    B, C2, L, n = ct.shape
    rank = C2 - 1
    sa = poly.automorphism(ct, g)
    x = sa[:, :rank, :Td].reshape(B, rank * Td, n)
    base = ct.clone()
    base[:, rank] += sa[:, rank]
    return fold(ctx, x, key[:, None], L, C2, base=base, sign=-1)


def split_level(ctx: NTTContext, ct, t_rot: int, g: int, key, fold):
    """One split-tree level: (child0, child1) = (one trace step on ct,
    normalize(X^-t (2 ct - child0))); key [P, rank * L, M, N]."""
    child0 = trace_step(ctx, ct, key, g, ct.shape[2], fold)
    child1 = limb_ops.normalize(poly.rotate(2 * ct - child0, -t_rot))
    return child0, child1


def pack_merge_level(ctx: NTTContext, A, B, t_rot: int, g: int, key, fold):
    """One pack-tree merge: normalize(u + KS(sigma_g(v))), u/v = A +- X^t B,
    rows [nb, C2, L, N]; key [P, rank * Td, M, N]."""
    nb, C2, L, n = A.shape
    rank = C2 - 1
    Td = key.shape[1] // rank
    xb = poly.rotate(B, t_rot)
    u = A + xb
    sv = poly.automorphism(A - xb, g)
    x = sv[:, :rank, :Td].reshape(nb, rank * Td, n)
    base = u.clone()
    base[:, rank] += sv[:, rank]
    return fold(ctx, x, key[:, None], L, C2, base=base, sign=-1)


# --------------------------------------------------------------------------
# kernel 3: the trace chain
# --------------------------------------------------------------------------

def fused_trace_plain(ctx: NTTContext, ct, keys_stacked, gal_els):
    S, P, T, M, n = keys_stacked.shape
    C2 = ct.shape[1]
    Td = T // (C2 - 1)
    for s, g in enumerate(gal_els):
        ct = trace_step(ctx, ct, keys_stacked[s], g, Td, fused_external_fold_plain)
    return ct


def fused_trace(ctx: NTTContext, ct, keys_stacked, gal_els):
    """The whole normalized-trace chain in one launch.

    ct: int32[B, C2, L, N] normalized; keys_stacked: int32[S, P, T, M, N]
    prepared automorphism keys (T = rank*Td, Td <= L the decomposed digits;
    M = C2*Lk); gal_els: the S galois elements.  Returns int32[B, C2, L, N]
    == the chain ct <- normalize(ct + KS(sigma_g(ct)))."""
    _require_radix2(ctx, "fused_trace")
    B, C2, L, n = ct.shape
    S, _, T, M, n3 = keys_stacked.shape
    rank = C2 - 1
    if n != ctx.n or n3 != n or T % rank or M % C2 or T // rank > L:
        raise ValueError(f"ct {tuple(ct.shape)} does not fit keys {tuple(keys_stacked.shape)}")
    if S != len(gal_els) or not 1 <= S <= _MAX_STEPS:
        raise ValueError(f"{S} steps: one launch chains 1..{_MAX_STEPS}")
    _fold_limits(T, M, C2, L, n)
    if not _use_kernel(ctx, ct):
        return fused_trace_plain(ctx, ct, keys_stacked, gal_els)
    polys = _staged_fold_polys(T, M, C2, "trace")
    ct = _aligned16(_require(ct, "ct"))
    keys_stacked = _aligned16(_require(keys_stacked, "keys_stacked"))
    out = torch.empty_like(ct)
    if B == 0:
        return out
    tmp = torch.empty_like(ct)
    steps = _TraceSteps()
    steps.count = S
    for s, g in enumerate(gal_els):
        steps.ginv[s] = poly.auto_inverse(n, g)
    sh = _fold_shape_arg(B, T, M, C2, L, -1)
    clusters = min(B, _MAX_ROW_GROUPS)
    with torch.cuda.device(ct.device):
        err = _lib("trace").fhe_trace(
            ct.data_ptr(), keys_stacked.data_ptr(), out.data_ptr(),
            tmp.data_ptr(), B, clusters, steps, T // rank,
            _fold_blocks(clusters * sh.cs, T, polys - T, ct.device), sh,
            _consts(ctx), _fold_tables(ctx, ct.device), _stream())
    _check(err, "fused_trace")
    LAUNCHES["fused_trace"] += 1
    return out


# --------------------------------------------------------------------------
# kernel 4: one pack-tree merge level
# --------------------------------------------------------------------------

def fused_pack_merge_plain(ctx: NTTContext, A, B, t_rot: int, g: int, key_ntt):
    return pack_merge_level(ctx, A, B, t_rot, g, key_ntt, fused_external_fold_plain)


def fused_pack_merge(ctx: NTTContext, A, B, t_rot: int, g: int, key_ntt):
    """One pack-tree merge level with all glue in the kernel:

        out = normalize(u + KS(sigma_g(v))),  u/v = A +- X^t B

    A, B: int32[nb, C2, L, N] (limbs up to 2^17 in magnitude: the first
    level takes the pre-shifted, unnormalized rows); key_ntt: int32[P, T,
    M, N] (T = rank*Td, M = C2*Lk).  Returns int32[nb, C2, L, N]."""
    _require_radix2(ctx, "fused_pack_merge")
    nb, C2, L, n = A.shape
    _, T, M, n3 = key_ntt.shape
    rank = C2 - 1
    if (tuple(B.shape) != tuple(A.shape) or n != ctx.n or n3 != n or T % rank
            or M % C2 or T // rank > L):
        raise ValueError(f"A {tuple(A.shape)}, B {tuple(B.shape)} do not fit key {tuple(key_ntt.shape)}")
    _fold_limits(T, M, C2, L, n)
    if not _use_kernel(ctx, A):
        return fused_pack_merge_plain(ctx, A, B, t_rot, g, key_ntt)
    polys = _staged_fold_polys(T, M, C2, "merge")
    A = _require(A, "A")
    B = _require(B, "B")
    key_ntt = _aligned16(_require(key_ntt, "key_ntt"))
    out = torch.empty_like(A)
    if nb == 0:
        return out
    sh = _fold_shape_arg(nb, T, M, C2, L, -1)
    clusters = min(nb, _MAX_ROW_GROUPS)
    with torch.cuda.device(A.device):
        err = _lib("pack_merge").fhe_pack_merge(
            A.data_ptr(), B.data_ptr(), key_ntt.data_ptr(), out.data_ptr(), nb,
            clusters, t_rot % (2 * n), poly.auto_inverse(n, g), T // rank,
            _fold_blocks(clusters * sh.cs, T, polys - T, A.device), sh, _consts(ctx),
            _fold_tables(ctx, A.device), _stream())
    _check(err, "fused_pack_merge")
    LAUNCHES["fused_pack_merge"] += 1
    return out


# --------------------------------------------------------------------------
# kernel 6: one split-tree level
# --------------------------------------------------------------------------

def fused_split_plain(ctx: NTTContext, ct, t_rot: int, g: int, key_ntt):
    return split_level(ctx, ct, t_rot, g, key_ntt, fused_external_fold_plain)


def fused_split(ctx: NTTContext, ct, t_rot: int, g: int, key_ntt):
    """One level of the slot-extraction split tree, both children from one
    keyswitch and one launch:

        child0 = normalize(ct + KS(sigma_g(ct)))
        child1 = normalize(X^-t (2 ct - child0))

    ct: int32[nb, C2, L, N] normalized; key_ntt: int32[P, T, M, N] with
    T = rank*L (the full gadget) and M = C2*Lk.  Returns (child0, child1),
    each int32[nb, C2, L, N]."""
    _require_radix2(ctx, "fused_split")
    nb, C2, L, n = ct.shape
    _, T, M, n3 = key_ntt.shape
    rank = C2 - 1
    if n != ctx.n or n3 != n or T != rank * L or M % C2:
        raise ValueError(f"ct {tuple(ct.shape)} does not fit key {tuple(key_ntt.shape)}")
    _fold_limits(T, M, C2, L, n)
    if not _use_kernel(ctx, ct):
        return fused_split_plain(ctx, ct, t_rot, g, key_ntt)
    polys = _staged_fold_polys(T, M, C2, "split")
    ct = _aligned16(_require(ct, "ct"))
    key_ntt = _aligned16(_require(key_ntt, "key_ntt"))
    out0, out1 = torch.empty_like(ct), torch.empty_like(ct)
    if nb == 0:
        return out0, out1
    sh = _fold_shape_arg(nb, T, M, C2, L, -1)
    clusters = min(nb, _MAX_ROW_GROUPS)
    with torch.cuda.device(ct.device):
        err = _lib("split").fhe_split(
            ct.data_ptr(), key_ntt.data_ptr(), out0.data_ptr(), out1.data_ptr(),
            nb, clusters, -t_rot % (2 * n), poly.auto_inverse(n, g),
            _fold_blocks(clusters * sh.cs, T, polys - T, ct.device), sh,
            _consts(ctx), _fold_tables(ctx, ct.device), _stream())
    _check(err, "fused_split")
    LAUNCHES["fused_split"] += 1
    return out0, out1


# --------------------------------------------------------------------------
# kernels 7 and 8: the one-launch split tree and pack tree
# --------------------------------------------------------------------------

# occupancy queries: (source, cs, blocks, polys, device index) ->
# co-resident clusters of a cooperative clustered launch on the fold body
# (the split tree, the pack tree, the bitwise group, the carry chain)
_resident = {}


def _max_clusters(source: str, sh: _FoldShape, blocks: int, polys: int, device) -> int:
    """The most clusters of sh.cs blocks of `source`'s instantiation
    `blocks` (2 or 1), each holding `polys` polys of shared memory, that the
    card holds at once (csrc/<source>.cu's fhe_<source>_clusters): the
    largest grid of a cooperative launch of it."""
    key = (source, sh.cs, blocks, polys, torch.device(device).index)
    if key not in _resident:
        clusters = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = getattr(_lib(source), f"fhe_{source}_clusters")(
                sh, blocks, ctypes.byref(clusters))
        _check(err, f"the occupancy query of {source}")
        _resident[key] = clusters.value
    return _resident[key]


def _tree_layout(source: str, level_rows, T: int, M: int, C2: int, L: int, device,
                 cs: int | None = None, blocks: int | None = None):
    """(shape argument, instantiation, clusters) of a launch of a tree
    kernel (`source` "split_tree" or "pack_tree") whose levels have
    level_rows rows (row pairs of the pack tree) each.  One cluster size
    serves every level: for each size (6 where the components split evenly,
    and 3), the instantiation `_fold_blocks` gives the widest level and the
    clusters the card holds at once with it; the levels then take sum_l
    ceil(rows_l / clusters) rounds of rows, a round priced by the
    transforms of one block, T + 3 M / cs.  The cheaper size wins (a single
    write's split tree, 4 roots: clusters of 6; a batched RMW's of 16, 64
    roots: of 3; the pack trees of 32 leaves likewise at 4 and 64 columns).
    cs and blocks given here override the choice
    (tools/time_bitwise_split_tree_predecessors.py and
    time_pack_tree_ntt_predecessors.py time the others).  Raises where the
    card holds no cluster."""
    what = source.replace("_", " ")
    polys = _staged_fold_polys(T, M, C2, what)
    widest = max(level_rows)
    best = None
    for cs_ in (cs,) if cs is not None else (6, 3) if C2 % 2 == 0 else (3,):
        sh = _FoldShape(T, M, M // C2, L, C2, -1, 0, cs_)
        b = blocks if blocks is not None else _fold_blocks(widest * cs_, T, polys - T, device)
        clusters = _max_clusters(source, sh, b, polys, device)
        if clusters < 1:
            continue
        cost = sum(-(-rows // clusters) for rows in level_rows) * (T + 3 * M / cs_)
        if best is None or cost < best[0]:
            best = (cost, sh, b, min(clusters, widest))
    if best is None:
        raise RuntimeError(f"{source}: the device holds no cluster of its blocks")
    return best[1:]


def fused_split_tree_plain(ctx: NTTContext, ct, gal_els, keys_stacked):
    """Plain version of `fused_split_tree`: a loop of `fused_split_plain`
    over the levels, children kept in the concat layout."""
    nb = ct.shape[0]
    nodes = ct[:, None]                               # [nb, 1, C2, L, N]
    for l, g in enumerate(gal_els):
        flat = nodes.reshape((-1,) + tuple(ct.shape[1:]))
        c0, c1 = fused_split_plain(ctx, flat, 1 << l, g, keys_stacked[l])
        nodes = torch.cat([c0.reshape((nb, -1) + tuple(ct.shape[1:])),
                           c1.reshape((nb, -1) + tuple(ct.shape[1:]))], dim=1)
    return nodes


def fused_split_tree(ctx: NTTContext, ct, gal_els, keys_stacked):
    """All S levels of the slot-extraction split tree in ONE launch.

    ct: int32[nb, C2, L, N] pre-scaled normalized roots; gal_els: the S
    per-level galois elements (level l pairs slots that differ in bit l:
    g_l = N/2^l + 1, back-rotation X^-2^l); keys_stacked: int32[S, P, T,
    M, N] prepared automorphism keys in level order, T = rank*L (the full
    gadget), M = C2*Lk.  Returns int32[nb, 2^S, C2, L, N]: node j of root
    b is the leaf for slot j, the same integers as S `fused_split`
    launches whose children are concatenated [child0s | child1s]."""
    _require_radix2(ctx, "fused_split_tree")
    nb, C2, L, n = ct.shape
    S, P, T, M, n3 = keys_stacked.shape
    rank = C2 - 1
    if n != ctx.n or n3 != n or T != rank * L or M % C2 or P != len(ctx.primes):
        raise ValueError(f"ct {tuple(ct.shape)} does not fit keys {tuple(keys_stacked.shape)}")
    if S != len(gal_els) or not 1 <= S <= _MAX_STEPS:
        raise ValueError(f"{S} levels: one launch walks 1..{_MAX_STEPS}")
    if keys_stacked.device != ct.device:
        raise ValueError(f"keys_stacked lies on {keys_stacked.device}, ct on {ct.device}")
    _fold_limits(T, M, C2, L, n)
    if not _use_kernel(ctx, ct):
        return fused_split_tree_plain(ctx, ct, gal_els, keys_stacked)
    out = _launch_split_tree(ctx, ct, gal_els, keys_stacked)
    if nb:
        LAUNCHES["fused_split_tree"] += 1
    return out


def _split_levels(gal_els, n: int) -> _SplitLevels:
    """csrc/split_tree.cu's level table: level l's g^-1 mod 2n and the
    back-rotation X^-2^l as X^t_back, t_back in [0, 2n)."""
    lv = _SplitLevels()
    lv.count = len(gal_els)
    for l, g in enumerate(gal_els):
        lv.ginv[l] = poly.auto_inverse(n, g)
        lv.t_back[l] = -(1 << l) % (2 * n)
    return lv


def _launch_split_tree(ctx: NTTContext, ct, gal_els, keys_stacked, cs: int | None = None,
                       blocks: int | None = None):
    """One launch of csrc/split_tree.cu on checked arguments, not counted
    (`fused_split_tree` counts it); the layout `_tree_layout`'s."""
    nb, C2, L, n = ct.shape
    S, P, T, M, _ = keys_stacked.shape
    ct = _aligned16(_require(ct, "ct"))
    keys_stacked = _aligned16(_require(keys_stacked, "keys_stacked"))
    out = torch.empty((nb, 1 << S, C2, L, n), dtype=I32, device=ct.device)
    if nb == 0:
        return out
    sh, blocks, clusters = _tree_layout("split_tree", [nb << l for l in range(S)], T, M, C2,
                                        L, ct.device, cs, blocks)
    lv = _split_levels(gal_els, n)
    tmp = torch.empty((nb, 1 << (S - 1), C2, L, n), dtype=I32, device=ct.device)
    arrived = torch.zeros((1,), dtype=I32, device=ct.device)
    with torch.cuda.device(ct.device):
        err = _lib("split_tree").fhe_split_tree(
            ct.data_ptr(), keys_stacked.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            arrived.data_ptr(), nb, clusters, lv, blocks, sh, _consts(ctx),
            _fold_tables(ctx, ct.device), _stream())
    _check(err, "fused_split_tree")
    return out


def fused_pack_tree_plain(ctx: NTTContext, cts, keys_stacked):
    """Plain version of `fused_pack_tree`: a loop of
    `fused_pack_merge_plain` over the levels."""
    M, nb = cts.shape[0], cts.shape[1]
    n = cts.shape[-1]
    levels = M.bit_length() - 1
    for s in range(levels):
        l = levels - 1 - s
        R = M >> (s + 1)
        merged = fused_pack_merge_plain(
            ctx, cts[:R].reshape((-1,) + tuple(cts.shape[2:])),
            cts[R: 2 * R].reshape((-1,) + tuple(cts.shape[2:])),
            1 << l, (n >> l) + 1, keys_stacked[s])
        cts = merged.reshape((R, nb) + tuple(cts.shape[2:]))
    return cts[0]


def fused_pack_tree(ctx: NTTContext, cts, keys_stacked):
    """A whole log-depth pack tree in ONE launch.

    cts: int32[M, nb, C2, L, N] leaves, M a power of two >= 2, pre-scaled
    by 1/M and not necessarily normalized (limbs up to 2^17 in magnitude);
    keys_stacked: int32[levels, P, T, Mk, N] prepared automorphism keys in
    MERGE order (level s uses g = N/2^(levels-1-s) + 1 and the rotation
    X^(2^(levels-1-s))), T = rank*L (the full gadget), Mk = C2*Lk.
    Returns int32[nb, C2, L, N], the same integers as log2(M)
    `fused_pack_merge` launches."""
    _require_radix2(ctx, "fused_pack_tree")
    M, nb, C2, L, n = cts.shape
    levels, P, T, Mk, n3 = keys_stacked.shape
    rank = C2 - 1
    if M < 2 or M & (M - 1) or levels != M.bit_length() - 1:
        raise ValueError(f"{M} leaves against {levels} levels of keys")
    if n != ctx.n or n3 != n or T != rank * L or Mk % C2 or P != len(ctx.primes):
        raise ValueError(f"cts {tuple(cts.shape)} do not fit keys {tuple(keys_stacked.shape)}")
    if levels > min(_MAX_STEPS, ctx.log_n):
        raise ValueError(f"{levels} levels: one launch walks 1..{min(_MAX_STEPS, ctx.log_n)}")
    if keys_stacked.device != cts.device:
        raise ValueError(f"keys_stacked lies on {keys_stacked.device}, cts on {cts.device}")
    _fold_limits(T, Mk, C2, L, n)
    if not _use_kernel(ctx, cts):
        return fused_pack_tree_plain(ctx, cts, keys_stacked)
    out = _launch_pack_tree(ctx, cts, keys_stacked)
    if nb:
        LAUNCHES["fused_pack_tree"] += 1
    return out


def _pack_levels(levels: int, n: int) -> _PackLevels:
    """csrc/pack_tree.cu's level table, in merge order: level s's g^-1 mod
    2n (g = n / t + 1) and rotation t = 2^(levels-1-s)."""
    lv = _PackLevels()
    lv.count = levels
    for s in range(levels):
        t = 1 << (levels - 1 - s)
        lv.ginv[s] = poly.auto_inverse(n, n // t + 1)
        lv.rot[s] = t % (2 * n)
    return lv


def _launch_pack_tree(ctx: NTTContext, cts, keys_stacked, cs: int | None = None,
                      blocks: int | None = None):
    """One launch of csrc/pack_tree.cu on checked arguments, not counted
    (`fused_pack_tree` counts it); the layout `_tree_layout`'s over the
    levels' (M >> (s + 1)) * nb row pairs; a zeroed counter a row pair of
    every level but the last."""
    M, nb, C2, L, n = cts.shape
    levels, P, T, Mk, _ = keys_stacked.shape
    cts = _require(cts, "cts")
    keys_stacked = _aligned16(_require(keys_stacked, "keys_stacked"))
    out = torch.empty((nb, C2, L, n), dtype=I32, device=cts.device)
    if nb == 0:
        return out
    sh, blocks, clusters = _tree_layout(
        "pack_tree", [(M >> (s + 1)) * nb for s in range(levels)], T, Mk, C2, L,
        cts.device, cs, blocks)
    tmp = torch.empty((max(1, M // 2 + M // 4), nb, C2, L, n), dtype=I32, device=cts.device)
    done = torch.zeros((max(1, (M - 2) * nb),), dtype=I32, device=cts.device)
    with torch.cuda.device(cts.device):
        err = _lib("pack_tree").fhe_pack_tree(
            cts.data_ptr(), keys_stacked.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            done.data_ptr(), M, nb, clusters, T // (C2 - 1), _pack_levels(levels, n),
            blocks, sh, _consts(ctx), _fold_tables(ctx, cts.device), _stream())
    _check(err, "fused_pack_tree")
    return out


# --------------------------------------------------------------------------
# kernels 9, 10 and 11: the VM's CMux chains
# --------------------------------------------------------------------------

def _chain_keys(keys, lead: int, C2: int, L: int, n: int, ctx: NTTContext):
    """Check stacked chain keys [..., P, T, M, N] (`lead` leading axes)
    against rows of C2 components and L limbs; returns (Td, T, M)."""
    shape = tuple(keys.shape)
    if len(shape) != lead + 4 or shape[-1] != n or n != ctx.n:
        raise ValueError(f"keys {shape} do not fit rows of [{C2}, {L}, {n}]")
    P, T, M = shape[lead:lead + 3]
    if P != len(ctx.primes) or T % C2 or M % C2 or not 1 <= T // C2 <= L:
        raise ValueError(f"keys {shape} do not fit rows of [{C2}, {L}, {n}]")
    _fold_limits(T, M, C2, L, n)
    return T // C2, T, M


def _cmux_rows_plain(ctx: NTTContext, hi, lo, key, Td: int):
    """normalize(lo + (hi - lo)[:Td] x key) of rows [R, C2, L, N] against
    one key [P, T, M, N]: the composed CMux, the fold's plain version."""
    R, C2, L, n = lo.shape
    x = (hi - lo)[:, :, :Td].reshape(R, C2 * Td, n)
    return fused_external_fold_plain(ctx, x, key[:, None], L, C2, base=lo)


def fused_blind_rotate_plain(ctx: NTTContext, rows, keys_stacked, amounts):
    """Plain version of `fused_blind_rotate`: one composed CMux a step."""
    Td = keys_stacked.shape[2] // rows.shape[1]
    for s, t in enumerate(amounts):
        rows = _cmux_rows_plain(ctx, poly.rotate(rows, t), rows,
                                keys_stacked[s], Td)
    return rows


def fused_blind_rotate(ctx: NTTContext, rows, keys_stacked, amounts):
    """A whole blind-rotation CMux chain in one launch:

        rows <- normalize(rows + (X^t_s rows - rows)[:Td] x GGSW_s)

    for s = 0 .. S-1.  rows: int32[B, C2, L, N] normalized; keys_stacked:
    int32[S, P, T, M, N] prepared bit-GGSW key rows (T = C2*Td, Td <= L the
    decomposed top limbs; M = C2*Lk); amounts: S static rotation exponents
    (any sign; X^N = -1).  Returns int32[B, C2, L, N]."""
    _require_radix2(ctx, "fused_blind_rotate")
    B, C2, L, n = rows.shape
    Td, T, M = _chain_keys(keys_stacked, 1, C2, L, n, ctx)
    S = keys_stacked.shape[0]
    if S != len(amounts) or not 1 <= S <= _MAX_STEPS:
        raise ValueError(f"{S} keys, {len(amounts)} amounts: one launch "
                         f"chains 1..{_MAX_STEPS} steps")
    if keys_stacked.device != rows.device:
        raise ValueError(f"keys_stacked lies on {keys_stacked.device}, rows on {rows.device}")
    if not _use_kernel(ctx, rows):
        return fused_blind_rotate_plain(ctx, rows, keys_stacked, amounts)
    polys = _staged_fold_polys(T, M, C2, "blind rotation")
    rows = _aligned16(_require(rows, "rows"))
    keys_stacked = _aligned16(_require(keys_stacked, "keys_stacked"))
    out = torch.empty_like(rows)
    if B == 0:
        return out
    tmp = torch.empty_like(rows)
    steps = _RotSteps()
    steps.count = S
    for s, t in enumerate(amounts):
        steps.rot[s] = int(t) % (2 * n)
    sh = _fold_shape_arg(B, T, M, C2, L, 1)
    clusters = min(B, _MAX_ROW_GROUPS)
    with torch.cuda.device(rows.device):
        err = _lib("blind_rotate").fhe_blind_rotate(
            rows.data_ptr(), keys_stacked.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            B, clusters, steps, Td,
            _fold_blocks(clusters * sh.cs, T, polys - T, rows.device), sh,
            _consts(ctx), _fold_tables(ctx, rows.device), _stream())
    _check(err, "fused_blind_rotate")
    LAUNCHES["fused_blind_rotate"] += 1
    return out


def _op_groups(groups, G: int):
    """Per-op index of its source group; the groups must partition the ops."""
    if sorted(gi for g in groups for gi in g) != list(range(G)):
        raise ValueError(f"groups {groups} do not partition {G} ops")
    if not 1 <= G <= _MAX_OPS:
        raise ValueError(f"{G} ops: one launch takes 1..{_MAX_OPS}")
    of = [0] * G
    for si, g in enumerate(groups):
        for gi in g:
            of[gi] = si
    return of


def dp_leaf_rows(emit: bool, subtab: bool, flip: bool, first: bool):
    """The four b-phase leaf rows of one carry-DP op, in the order (a, c) =
    (0, 0), (0, 1), (1, 0), (1, 1): each (co0, co1, ob0, ob1), the carry-out
    and the emitted bit for b = 0 and b = 1.  `flip` (slt: both MSBs
    complemented) applies at the first step, the MSB, only."""
    rows = []
    for a in (0, 1):
        for c in (0, 1):
            co, ob = [], []
            for b in (0, 1):
                aa = 1 - a if (flip and first) else a
                bb = 1 - b if (flip and first) else b
                eff = (1 - bb) if subtab else bb
                co.append((aa + eff + c) >> 1)
                ob.append(((aa ^ eff ^ c) if subtab else (aa ^ bb ^ c))
                          if emit else 0)
            rows.append((co[0], co[1], ob[0], ob[1]))
    return rows


def fused_dp_chain_plain(ctx: NTTContext, F0, keys_stacked, deltas, op_tables,
                         groups):
    """Plain version of `fused_dp_chain`: per step one composed CMux over
    each source group's leaf rows, then one over the a-phase rows."""
    G, _, C2, L, n = F0.shape
    bits = keys_stacked.shape[0]
    NG = len(groups)
    Td = keys_stacked.shape[3] // C2
    F = F0
    for d in range(bits):
        delta = deltas[d]
        inner = [None] * G
        for si, gis in enumerate(groups):
            his, los = [], []
            for gi in gis:
                for co0, co1, ob0, ob1 in dp_leaf_rows(*op_tables[gi], d == 0):
                    his.append(F[gi, co1] + ob1 * delta)
                    los.append(F[gi, co0] + ob0 * delta)
            res = _cmux_rows_plain(ctx, torch.stack(his), torch.stack(los),
                                   keys_stacked[d, si], Td)
            for k, gi in enumerate(gis):
                inner[gi] = res[4 * k: 4 * k + 4]
        inner = torch.stack(inner)                  # [G, 4, C2, L, N]
        F = _cmux_rows_plain(ctx, inner[:, 2:].reshape(2 * G, C2, L, n),
                             inner[:, :2].reshape(2 * G, C2, L, n),
                             keys_stacked[d, NG], Td).reshape(G, 2, C2, L, n)
    return F


def fused_dp_chain(ctx: NTTContext, F0, keys_stacked, deltas, op_tables, groups):
    """The VM's whole carry-DP chain (MSB to LSB) in one launch.

    F0: int32[G, 2, C2, L, N] initial per-op 2-state, normalized;
    keys_stacked: int32[bits, NG+1, P, T, M, N] prepared bit-GGSW key rows
      in STEP order (MSB first): per step one key per b-operand source
      group, then the a-operand's (T = C2*Td, Td <= L; M = C2*Lk);
    deltas: int32[bits, C2, L, N] the emitted-bit plaintext word of each
      step, in step order;
    op_tables[g] = (emit, subtab, flip) of op g; groups: per source group
      the tuple of its op indices.
    Returns int32[G, 2, C2, L, N]: the state after the last step."""
    _require_radix2(ctx, "fused_dp_chain")
    G, two, C2, L, n = F0.shape
    bits = keys_stacked.shape[0]
    of = _op_groups(groups, G)
    NG = len(groups)
    _chain_keys(keys_stacked, 2, C2, L, n, ctx)
    if (two != 2 or keys_stacked.shape[1] != NG + 1 or len(op_tables) != G
            or tuple(deltas.shape) != (bits, C2, L, n) or bits < 1):
        raise ValueError(f"F0 {tuple(F0.shape)}, keys {tuple(keys_stacked.shape)}, "
                         f"deltas {tuple(deltas.shape)} and {len(op_tables)} op "
                         f"tables do not fit {NG} groups")
    for name, t in (("keys_stacked", keys_stacked), ("deltas", deltas)):
        if t.device != F0.device:
            raise ValueError(f"{name} lies on {t.device}, F0 on {F0.device}")
    if not _use_kernel(ctx, F0):
        return fused_dp_chain_plain(ctx, F0, keys_stacked, deltas, op_tables,
                                    groups)
    out = _launch_dp_chain(ctx, F0, keys_stacked, deltas, _dp_tables(op_tables, of))
    LAUNCHES["fused_dp_chain"] += 1
    return out


def _dp_tables(op_tables, of) -> _DpTables:
    """csrc/dp_chain.cu's table: each op's source group and its leaf rows'
    codes co0 | co1 << 1 | ob0 << 2 | ob1 << 3, later steps then the first."""
    tab = _DpTables()
    tab.count = len(of)
    for g, grp in enumerate(of):
        tab.group[g] = grp
        for first in (0, 1):
            for r, (co0, co1, ob0, ob1) in enumerate(
                    dp_leaf_rows(*op_tables[g], bool(first))):
                tab.leaf[(g * 2 + first) * 4 + r] = co0 | co1 << 1 | ob0 << 2 | ob1 << 3
    return tab


def _launch_dp_chain(ctx: NTTContext, F0, keys_stacked, deltas, tab: _DpTables,
                     cs: int | None = None, blocks: int | None = None):
    """One launch of csrc/dp_chain.cu on checked CUDA arguments, not counted
    (`fused_dp_chain` counts it).  The layout: four clusters an op (its four
    b-phase rows), cs blocks a cluster (_fold_cs of the 4 G rows), the
    instantiation `blocks` (_fold_blocks of the 4 G cs blocks), as many ops
    in flight as the card holds at once; cs and blocks given here override
    the choice (tools/time_chain_predecessors.py times the others).  Raises
    where one op's four clusters do not fit the card."""
    G, _, C2, L, n = F0.shape
    bits, NG1, _, T, M, _ = keys_stacked.shape
    polys = _staged_fold_polys(T, M, C2, "carry chain")
    F0 = _aligned16(_require(F0, "F0"))
    keys_stacked = _aligned16(_require(keys_stacked, "keys_stacked"))
    deltas = _aligned16(_require(deltas, "deltas"))
    sh = _fold_shape_arg(4 * G, T, M, C2, L, 1)
    if cs is not None:
        sh.cs = cs
    if blocks is None:
        blocks = _fold_blocks(4 * G * sh.cs, T, polys - T, F0.device)
    resident = _max_clusters("dp_chain", sh, blocks, polys, F0.device)
    groups_ = min(G, resident // 4)
    if groups_ < 1:
        raise RuntimeError(f"dp_chain: an op takes 4 clusters of {sh.cs} blocks, the "
                           f"device holds {resident} at once")
    out = torch.empty_like(F0)
    inner = torch.empty((G, 4, C2, L, n), dtype=I32, device=F0.device)
    arrived = torch.zeros((groups_,), dtype=I32, device=F0.device)
    with torch.cuda.device(F0.device):
        err = _lib("dp_chain").fhe_dp_chain(
            F0.data_ptr(), keys_stacked.data_ptr(), deltas.data_ptr(), out.data_ptr(),
            inner.data_ptr(), arrived.data_ptr(), groups_, tab, bits, NG1 - 1,
            T // C2, blocks, sh, _consts(ctx), _fold_tables(ctx, F0.device), _stream())
    _check(err, "fused_dp_chain")
    return out


def fused_bitwise_plain(ctx: NTTContext, leaves_hi, leaves_lo, keys_stacked,
                        groups):
    """Plain version of `fused_bitwise`: one composed keyed CMux over each
    source group's leaf rows (key j for bit j), then one over the a-level."""
    G, _, C2, L, n = leaves_hi.shape
    W = keys_stacked.shape[0]
    NG = len(groups)
    Td = keys_stacked.shape[3] // C2
    P, T, M = keys_stacked.shape[2:5]
    inner = [None] * G
    for si, gis in enumerate(groups):
        hi = leaves_hi[list(gis)].reshape(1, 2 * len(gis), C2, L, n)
        lo = leaves_lo[list(gis)].reshape(1, 2 * len(gis), C2, L, n)
        x = (hi - lo)[:, :, :, :Td].reshape(1, 2 * len(gis), T, n).expand(
            W, -1, -1, -1)
        res = fused_external_fold_batched_plain(
            ctx, x, keys_stacked[:, si].reshape(W, P, 1, T, M, n), L, C2,
            base=lo.expand(W, -1, -1, -1, -1))
        for k, gi in enumerate(gis):
            inner[gi] = res[:, 2 * k: 2 * k + 2]
    inner = torch.stack(inner, dim=1)              # [W, G, 2, C2, L, N]
    hi, lo = inner[:, :, 0], inner[:, :, 1]
    x = (hi - lo)[:, :, :, :Td].reshape(W, G, T, n)
    return fused_external_fold_batched_plain(
        ctx, x, keys_stacked[:, NG].reshape(W, P, 1, T, M, n), L, C2, base=lo)


def fused_bitwise(ctx: NTTContext, leaves_hi, leaves_lo, keys_stacked, groups):
    """All W bits of the VM's bitwise group in one launch.

    leaves_hi / leaves_lo: int32[G, 2, C2, L, N] the constant truth-table
      arms of each op, (l11, l01) / (l10, l00);
    keys_stacked: int32[W, NG+1, P, T, M, N] prepared key rows of bit j:
      one per b-operand source group, then the a-operand's (T = C2*Td);
    groups: per source group the tuple of its op indices.
    Returns int32[W, G, C2, L, N]: out[j, g] = CMux(a_j; CMux(b_j; l11,
    l10), CMux(b_j; l01, l00)) for op g."""
    _require_radix2(ctx, "fused_bitwise")
    G, two, C2, L, n = leaves_hi.shape
    W = keys_stacked.shape[0]
    of = _op_groups(groups, G)
    NG = len(groups)
    _chain_keys(keys_stacked, 2, C2, L, n, ctx)
    if (two != 2 or tuple(leaves_lo.shape) != tuple(leaves_hi.shape)
            or keys_stacked.shape[1] != NG + 1 or W < 1):
        raise ValueError(f"leaves {tuple(leaves_hi.shape)} / {tuple(leaves_lo.shape)} "
                         f"and keys {tuple(keys_stacked.shape)} do not fit {NG} groups")
    for name, t in (("keys_stacked", keys_stacked), ("leaves_lo", leaves_lo)):
        if t.device != leaves_hi.device:
            raise ValueError(f"{name} lies on {t.device}, leaves_hi on {leaves_hi.device}")
    if not _use_kernel(ctx, leaves_hi):
        return fused_bitwise_plain(ctx, leaves_hi, leaves_lo, keys_stacked, groups)
    out = _launch_bitwise(ctx, leaves_hi, leaves_lo, keys_stacked, of)
    LAUNCHES["fused_bitwise"] += 1
    return out


def _launch_bitwise(ctx: NTTContext, leaves_hi, leaves_lo, keys_stacked, of,
                    cs: int | None = None, blocks: int | None = None):
    """One launch of csrc/bitwise.cu on checked CUDA arguments, not counted
    (`fused_bitwise` counts it); `of`: each op's source group.  The layout:
    the 2G leaf rows' spectra and the 3 W G rows (2 W G level-1, W G
    level-2) dealt over persistent clusters of cs blocks (_fold_cs of the
    rows), the instantiation `blocks` (_fold_blocks of one cluster a row),
    as many clusters as the card holds at once; cs and blocks given here
    override the choice (tools/time_bitwise_split_tree_predecessors.py
    times the others)."""
    G, _, C2, L, n = leaves_hi.shape
    W, NG1, _, T, M, _ = keys_stacked.shape
    polys = _staged_fold_polys(T, M, C2, "bitwise group")
    hi = _aligned16(_require(leaves_hi, "leaves_hi"))
    lo = _aligned16(_require(leaves_lo, "leaves_lo"))
    keys_stacked = _aligned16(_require(keys_stacked, "keys_stacked"))
    rows = 3 * W * G
    sh = _fold_shape_arg(rows, T, M, C2, L, 1)
    if cs is not None:
        sh.cs = cs
    if blocks is None:
        blocks = _fold_blocks(rows * sh.cs, T, polys - T, hi.device)
    clusters = min(rows + 2 * G, _max_clusters("bitwise", sh, blocks, polys, hi.device))
    if clusters < 1:
        raise RuntimeError(f"bitwise: the device holds no cluster of {sh.cs} blocks")
    ops = _OpGroups()
    ops.count = G
    for g in range(G):
        ops.group[g] = of[g]
    out = torch.empty((W, G, C2, L, n), dtype=I32, device=hi.device)
    inner = torch.empty((W, G, 2, C2, L, n), dtype=I32, device=hi.device)
    spectra = torch.empty((2 * G, len(ctx.primes), T, n), dtype=I32, device=hi.device)
    done = torch.zeros((W * G + 2 * G,), dtype=I32, device=hi.device)
    with torch.cuda.device(hi.device):
        err = _lib("bitwise").fhe_bitwise(
            hi.data_ptr(), lo.data_ptr(), keys_stacked.data_ptr(), out.data_ptr(),
            inner.data_ptr(), spectra.data_ptr(), done.data_ptr(), clusters, ops, W,
            NG1 - 1, T // C2, blocks, sh, _consts(ctx), _fold_tables(ctx, hi.device),
            _stream())
    _check(err, "fused_bitwise")
    return out
