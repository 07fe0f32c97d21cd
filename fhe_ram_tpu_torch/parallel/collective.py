"""The collectives of the row-sharded pack (parallel/mesh.py): a ring
all-gather and an XOR-partner exchange over the `rows` shards, each one
hand-written CUDA kernel (csrc/collective.cu), with its plain PyTorch
version beside it.

Counterpart of fhe_ram_tpu/parallel/collective.py.  A shard's chunk is a
tensor, the shards' chunks a list in shard order.  On one card every chunk
lies in the same device memory and the kernels move them between the
shards' own buffers; the kernels take a table of one input and one output
pointer a shard, which on distinct cards would hold peer-mapped pointers
(not in this package yet: parallel/mesh.make_mesh refuses such a mesh).

The reference picks its pack-root exchange with FHERAM_RING_AG: XLA's
all_gather (0), the Pallas ring (1), or the merge-interleaved exchange (2).
Here the mesh's factory functions take `collective="ring"` (the default) or
`"exchange"`; XLA's all_gather has no counterpart, since a library
all-gather is not the ring.

Dispatch as in ops/ntt_cuda.py: CUDA chunks launch the kernel or raise;
CPU chunks take the plain version, and so does every chunk under
ntt_cuda.plain_versions().  The launch counts are ntt_cuda.LAUNCHES'
"ring_all_gather" and "exchange"."""

from __future__ import annotations

import torch

from ..ops import ntt_cuda
from ..ops.modular import I32

COLLECTIVES = ("ring", "exchange")


def check_collective(collective: str) -> str:
    if collective not in COLLECTIVES:
        raise ValueError(f"collective {collective!r}: one of {COLLECTIVES} "
                         "(the reference's XLA all_gather has no counterpart)")
    return collective


def _check_chunks(chunks) -> list:
    """The shards' chunks: a non-empty list of int32 tensors of one shape
    on one device."""
    chunks = list(chunks)
    if not chunks:
        raise ValueError("no shard to gather")
    first = chunks[0]
    for k, c in enumerate(chunks):
        if c.dtype != I32:
            raise TypeError(f"chunk {k}: int32 expected, got {c.dtype}")
        if c.shape != first.shape:
            raise ValueError(f"chunk {k}: shape {tuple(c.shape)} != "
                             f"{tuple(first.shape)}")
        if c.device != first.device:
            raise NotImplementedError(
                f"chunk {k} lies on {c.device}, chunk 0 on {first.device}: "
                "collectives over distinct devices are not ported yet "
                "(ROADMAP.md, queue 1: a mesh over distinct cards)")
    if len(chunks) > ntt_cuda.MAX_SHARDS:
        raise ValueError(f"{len(chunks)} shards: at most {ntt_cuda.MAX_SHARDS}")
    return chunks


def _use_kernel(chunks) -> bool:
    return chunks[0].is_cuda and not ntt_cuda._force_plain


def _kernel_inputs(chunks) -> list:
    """The chunks as the kernels read them: contiguous, 16-byte aligned
    (a misaligned view is copied into a fresh tensor) and a whole number
    of 16-byte units (every chunk of the pack is [.., N], N >= 64)."""
    if chunks[0].numel() % 4:
        raise ValueError(f"chunk {tuple(chunks[0].shape)}: the kernels move "
                         "16 bytes at a time, so numel must be a multiple of 4")
    return [c if c.is_contiguous() and c.data_ptr() % 16 == 0
            else c.clone(memory_format=torch.contiguous_format) for c in chunks]


def _table(ins, outs):
    """The pointer table of the shards' inputs and outputs."""
    table = ntt_cuda.ShardPtrs()
    for k, (i, o) in enumerate(zip(ins, outs)):
        table.inp[k], table.out[k] = i.data_ptr(), o.data_ptr()
    return table


# --------------------------------------------------------------------------
# kernel 13: ring all-gather
# --------------------------------------------------------------------------

def ring_all_gather_plain(chunks):
    """Plain version of `ring_all_gather`: every shard's output is the
    stack of all chunks in shard order."""
    chunks = _check_chunks(chunks)
    return [torch.stack(chunks) for _ in chunks]


def ring_all_gather(chunks):
    """All-gather one chunk a shard: returns, for every shard k, a new
    tensor [n, *chunk.shape] with out_k[s] = chunks[s] -- a drop-in for
    the reference's ring_all_gather inside its shard_map.  One kernel
    launch (csrc/collective.cu: n - 1 ring hops in one cooperative
    launch); one shard returns chunks[0][None] and launches nothing."""
    chunks = _check_chunks(chunks)
    n = len(chunks)
    if n == 1:
        return [chunks[0][None]]
    if not _use_kernel(chunks):
        return ring_all_gather_plain(chunks)
    ins = _kernel_inputs(chunks)
    outs = [torch.empty((n,) + tuple(c.shape), dtype=I32, device=c.device)
            for c in ins]
    if ins[0].numel():
        with torch.cuda.device(ins[0].device):
            err = ntt_cuda._lib("collective").fhe_ring_all_gather(
                _table(ins, outs), n, ins[0].numel(), ntt_cuda._stream())
        ntt_cuda._check(err, "ring_all_gather")
        ntt_cuda.LAUNCHES["ring_all_gather"] += 1
    return outs


# --------------------------------------------------------------------------
# kernel 14: partner exchange
# --------------------------------------------------------------------------

def _check_stride(n: int, stride: int):
    if not (0 < stride < n and stride & (stride - 1) == 0
            and n % (2 * stride) == 0):
        raise ValueError(f"exchange stride {stride} over {n} shards: a power "
                         "of two below n, and n a multiple of 2 * stride")


def exchange_plain(chunks, stride: int):
    """Plain version of `exchange`: out_k = chunks[k ^ stride]."""
    chunks = _check_chunks(chunks)
    _check_stride(len(chunks), stride)
    return [chunks[k ^ stride].clone() for k in range(len(chunks))]


def exchange(chunks, stride: int):
    """Bidirectional partner exchange: every shard k receives the chunk of
    shard k XOR stride, in a new tensor -- the primitive of the
    merge-interleaved pack tail (mesh._merge_exchange_tail).  One kernel
    launch (csrc/collective.cu)."""
    chunks = _check_chunks(chunks)
    n = len(chunks)
    _check_stride(n, stride)
    if not _use_kernel(chunks):
        return exchange_plain(chunks, stride)
    ins = _kernel_inputs(chunks)
    outs = [torch.empty_like(c) for c in ins]
    if ins[0].numel():
        with torch.cuda.device(ins[0].device):
            err = ntt_cuda._lib("collective").fhe_exchange(
                _table(ins, outs), n, stride, ins[0].numel(), ntt_cuda._stream())
        ntt_cuda._check(err, "exchange")
        ntt_cuda.LAUNCHES["exchange"] += 1
    return outs
