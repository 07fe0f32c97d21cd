"""The one-launch tree kernels' plain versions and the tree functions of
core/packer.py and core/keyswitch.py, held against the per-level kernels'
plain versions and against the JAX package on the same inputs, on the CPU.

The JAX side runs its composed path under jax.jit (one jitted function a
test, so that what its outputs share compiles once); the port runs on CPU
tensors, where each wrapper takes its kernel's plain version.  Keys and
ciphertexts are random int32 arrays of a log_n = 6 preset's shapes, made
from a seed with numpy and prepared by each side's own `prepare`; outputs
are compared bit for bit (np.array_equal / torch.equal, tolerance 0:
integer arithmetic)."""

import functools
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fhe_ram_tpu.params import PARAMS_TEST_SMALL_WIDE as JWIDE
from fhe_ram_tpu.ops.ntt import get_ntt_context as jget_ctx
from fhe_ram_tpu.core import keyswitch as jks
from fhe_ram_tpu.core import packer as jpacker

from fhe_ram_tpu_torch.params import PARAMS_TEST_SMALL_WIDE as TWIDE
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context as tget_ctx
from fhe_ram_tpu_torch.ops import limb as tlimb
from fhe_ram_tpu_torch.ops import ntt_cuda
from fhe_ram_tpu_torch.core import keyswitch as tks
from fhe_ram_tpu_torch.core import packer as tpacker

# one intra-op thread: the suite runs several workers side by side, and
# these sizes gain nothing from more
torch.set_num_threads(1)

# The JAX reference is compiled without XLA's optimisation passes and in one
# piece: the integers are the same, these sizes run in no time either way,
# and the compile takes a third less CPU time (the suite's workers share
# their cores, so CPU time is what the whole run pays for).
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_cpu_parallel_codegen_split_count": 1})

JCTX = jget_ctx(JWIDE.n, JWIDE.primes)
TCTX = tget_ctx(TWIDE.n, TWIDE.primes)
C, L, N = JWIDE.rank + 1, JWIDE.limbs_ct, JWIDE.n


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _limbs(rnd, shape, bits=16):
    return rnd.integers(-(1 << bits), 1 << bits, size=shape).astype(np.int32)


def _atk(rnd, gals):
    """({g: key polys for jax}, {g: the port's prepared key})."""
    shape = (JWIDE.dnum_ct, JWIDE.rank, C, JWIDE.limbs_evk_trace, N)
    atk = {g: _limbs(rnd, shape) for g in gals}
    return ({g: jnp.asarray(k) for g, k in atk.items()},
            {g: tks.key_prepare(TCTX, _t(k)) for g, k in atk.items()})


def _jprep(ks):
    return {g: jks.key_prepare(JCTX, k) for g, k in ks.items()}


def _split_levels(ct, gals, tk):
    """S launches of the per-level split in the extract_slots layout."""
    nodes = ct[:, None]
    for l, g in enumerate(gals):
        c0, c1 = ntt_cuda.fused_split(TCTX, nodes.reshape((-1,) + ct.shape[1:]),
                                      1 << l, g, tks.kernel_key_rows(tk[g]))
        nodes = torch.cat([c0.reshape((ct.shape[0], -1) + ct.shape[1:]),
                           c1.reshape((ct.shape[0], -1) + ct.shape[1:])], dim=1)
    return nodes


@pytest.fixture(scope="module")
def extraction():
    """One ciphertext batch, its keys, and the JAX package's extractions of
    it: all 8 slots (three split levels, no tail: bounded support), two of
    its residue classes, and 3 of 4 slots with the tail.  One jitted
    function: the trees share their levels."""
    rnd = np.random.default_rng(61)
    jk, tk = _atk(rnd, JWIDE.trace_gal_els)
    ct = _limbs(rnd, (2, C, L, N))

    def extractions(c, k, r):
        kp = _jprep(k)
        ex = lambda count, **kw: jks.extract_slots(JWIDE, JCTX, c, count, kp, **kw)
        return {"full": ex(8, bounded_support=True),
                "d2": ex(8, bounded_support=True, dilate=2, residue=r),
                "d8": ex(8, bounded_support=True, dilate=8, residue=5),
                "tail": ex(3)}

    want = {k: np.asarray(v) for k, v in _jit(extractions)(
        jnp.asarray(ct), jk, jnp.int32(1)).items()}
    return _t(ct), tk, want


def test_split_tree_plain_equals_the_per_level_splits_and_jax(extraction):
    ct, tk, want = extraction
    gals = TWIDE.trace_gal_els[:3]
    keys = torch.stack([tks.kernel_key_rows(tk[g]) for g in gals])
    # extract_slots' pre-scale by 2^-3, then the tree
    roots = tlimb.normalize(tlimb.shift_right(ct, 3))
    got = ntt_cuda.fused_split_tree(TCTX, roots, gals, keys)
    assert got.shape == (2, 8, C, L, N) and got.dtype == torch.int32
    assert torch.equal(got, _split_levels(roots, gals, tk))
    assert torch.equal(got, ntt_cuda.fused_split_tree_plain(TCTX, roots, gals, keys))
    assert np.array_equal(got.numpy(), want["full"])
    # one level: the smallest tree
    one = ntt_cuda.fused_split_tree(TCTX, roots, gals[:1], keys[:1])
    assert torch.equal(one, _split_levels(roots, gals[:1], tk))


@pytest.mark.parametrize("tree", [False, True], ids=["per_level", "one_launch"])
def test_extract_slots_routes_match_jax(extraction, tree):
    """Both routes of extract_slots, without and with the tail (3 slots of
    4: two levels, then log_n - 2 trace steps a leaf, the last leaf
    dropped)."""
    ct, tk, want = extraction
    got = tks.extract_slots(TWIDE, TCTX, ct, 8, tk, bounded_support=True, tree=tree)
    assert np.array_equal(got.numpy(), want["full"])
    got = tks.extract_slots(TWIDE, TCTX, ct, 3, tk, tree=tree)
    assert got.shape == (2, 3, C, L, N)
    assert np.array_equal(got.numpy(), want["tail"])


@pytest.mark.parametrize("case,count,dilate,residue,bounded", [
    ("d2", 8, 2, 1, True), ("d2", 8, 2, torch.tensor(1), True),
    ("d8", 8, 8, 5, True), ("tail_d2", 4, 2, 1, False)],
    ids=["dilate_2", "dilate_2_tensor_residue", "dilate_is_the_tree",
         "dilate_2_with_tail"])
def test_extract_slots_dilate_matches_jax_and_the_strided_slice(
        extraction, case, count, dilate, residue, bounded):
    ct, tk, want = extraction
    got = tks.extract_slots(TWIDE, TCTX, ct, count, tk, bounded_support=bounded,
                            dilate=dilate, residue=residue)
    assert got.shape == (2, count // dilate, C, L, N)
    if case in want:
        assert np.array_equal(got.numpy(), want[case])
    full = tks.extract_slots(TWIDE, TCTX, ct, count, tk, bounded_support=bounded)
    assert torch.equal(got, full[:, int(residue)::dilate])
    # the one-launch route is for dilate == 1: asked for, it changes nothing
    assert torch.equal(got, tks.extract_slots(
        TWIDE, TCTX, ct, count, tk, bounded_support=bounded, dilate=dilate,
        residue=residue, tree=True))


@pytest.fixture(scope="module")
def packing():
    """Eight leaves, their keys, and the JAX package's packs of them: pack,
    the dilated trees (r = 2) with their tail, and the prefix down to 2
    nodes with its tail.  One jitted function."""
    rnd = np.random.default_rng(62)
    gals = [(N >> l) + 1 for l in range(3)]
    jk, tk = _atk(rnd, gals)
    cts = _limbs(rnd, (8, 3, C, L, N))

    def packs(c, k):
        kp = _jprep(k)
        out = {"pack": jpacker.pack(JWIDE, JCTX, c, kp)}
        out["roots2"] = jnp.stack([
            jpacker.pack_tree(JWIDE, JCTX, c[i::2], kp, dilate=2) for i in range(2)])
        out["tail2"] = jpacker.pack_tree(JWIDE, JCTX, out["roots2"], kp,
                                         dilate=1, prescale=False)
        out["prefix"] = jpacker.pack_prefix(JWIDE, JCTX, c, kp, 2)
        out["prefix_tail"] = jpacker.pack_tree(JWIDE, JCTX, out["prefix"], kp,
                                               dilate=1, prescale=False)
        return out

    want = {k: np.asarray(v) for k, v in _jit(packs)(jnp.asarray(cts), jk).items()}
    return _t(cts), tk, want


def test_pack_tree_plain_equals_the_per_level_merges_and_jax(packing):
    cts, tk, want = packing
    keys = torch.stack([tks.kernel_key_rows(tk[(N >> (2 - s)) + 1])
                        for s in range(3)])                  # merge order
    leaves = tlimb.shift_right(cts, 3)    # pre-scaled, not normalized
    got = ntt_cuda.fused_pack_tree(TCTX, leaves, keys)
    assert got.shape == (3, C, L, N) and got.dtype == torch.int32
    cur = leaves
    for l in (2, 1, 0):
        cur = tpacker._merge_level(TWIDE, TCTX, cur[: 1 << l], cur[1 << l: 2 << l],
                                   1 << l, (N >> l) + 1, tk[(N >> l) + 1])
    assert torch.equal(got, cur[0])
    assert torch.equal(got, ntt_cuda.fused_pack_tree_plain(TCTX, leaves, keys))
    assert np.array_equal(got.numpy(), want["pack"])
    # two leaves: the smallest tree
    two = ntt_cuda.fused_pack_tree(TCTX, leaves[:2], keys[2:])
    assert torch.equal(two, tpacker._merge_level(
        TWIDE, TCTX, leaves[:1], leaves[1:2], 1, N + 1, tk[N + 1])[0])


def test_pack_routes_match_jax(packing, monkeypatch):
    """pack per level, pack through the one-launch tree, and the tree
    after per-level merges down to the routing bound (set to 2 here)."""
    cts, tk, want = packing
    assert np.array_equal(tpacker.pack(TWIDE, TCTX, cts, tk).numpy(), want["pack"])
    assert np.array_equal(tpacker.pack(TWIDE, TCTX, cts, tk, tree=True).numpy(),
                          want["pack"])
    monkeypatch.setattr(tpacker, "_TREE_MAX", 2)
    assert np.array_equal(tpacker.pack(TWIDE, TCTX, cts, tk, tree=True).numpy(),
                          want["pack"])
    # a truncated pack keeps the per-level kernels and says so, once
    monkeypatch.setattr(tpacker, "_warned_tree_trunc", False)
    trunc = (2, 3)
    with pytest.warns(UserWarning, match="per-level"):
        got = tpacker.pack(TWIDE, TCTX, cts, tk, trunc=trunc, tree=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = tpacker.pack(TWIDE, TCTX, cts, tk, trunc=trunc, tree=True)
    assert torch.equal(got, again)
    assert torch.equal(got, tpacker.pack(TWIDE, TCTX, cts, tk, trunc=trunc))


@pytest.mark.parametrize("r", [2, 4])
def test_pack_tree_dilated_plus_tail_matches_pack_and_jax(packing, r):
    cts, tk, want = packing
    roots = torch.stack([tpacker.pack_tree(TWIDE, TCTX, cts[i::r], tk, dilate=r)
                         for i in range(r)])
    got = tpacker.pack_tree(TWIDE, TCTX, roots, tk, dilate=1, prescale=False)
    if r == 2:   # the JAX package ran this decomposition too
        assert np.array_equal(roots.numpy(), want["roots2"])
        assert np.array_equal(got.numpy(), want["tail2"])
    assert np.array_equal(got.numpy(), want["pack"])


def test_pack_prefix_plus_tail_matches_pack_and_jax(packing):
    cts, tk, want = packing
    pref = tpacker.pack_prefix(TWIDE, TCTX, cts, tk, 2)
    assert pref.shape == (2, 3, C, L, N)
    assert np.array_equal(pref.numpy(), want["prefix"])
    got = tpacker.pack_tree(TWIDE, TCTX, pref, tk, dilate=1, prescale=False)
    assert np.array_equal(got.numpy(), want["prefix_tail"])
    assert np.array_equal(got.numpy(), want["pack"])
    # stop at all leaves: only the pre-scale; stop at one: the whole pack
    assert torch.equal(tpacker.pack_prefix(TWIDE, TCTX, cts, tk, 8),
                       tlimb.shift_right(cts, 3))
    assert np.array_equal(tpacker.pack_prefix(TWIDE, TCTX, cts, tk, 1)[0].numpy(),
                          want["pack"])
