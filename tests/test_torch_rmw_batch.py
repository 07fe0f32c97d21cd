"""The PyTorch port's batched read-modify-write on its own client, on the
CPU: pre-write words out, all words land, a neighbour unchanged; the tree
kernels' route (tree_kernels=True: one-launch pack and split trees, here
their plain versions) gives the integers of the per-level route; the
batched GGSW inversion those of the per-address one; refusals.

Single-level and three-level geometries (n2 = 1: no pack, no extraction;
n2 = 3: a two-chunk level-0 pack and the mid loop of the delta walk).  The
two-level geometry runs against the JAX package in
tests/test_torch_read.py.  Comparisons are torch.equal (integer
arithmetic, tolerance 0)."""

import numpy as np
import pytest
import torch

from fhe_ram_tpu_torch import params as tparams
from fhe_ram_tpu_torch.convert import stack_addresses
from fhe_ram_tpu_torch.ops import ntt_cuda
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context
from fhe_ram_tpu_torch.core import glwe, keys as keys_mod, rng
from fhe_ram_tpu_torch.ram import address as address_mod
from fhe_ram_tpu_torch.ram import ram as ram_mod

# one intra-op thread: the suite runs several workers side by side, and
# these sizes gain nothing from more
torch.set_num_threads(1)

B = 3


class _Client:
    """The port's own client at a preset: keys, an encrypted RAM, B
    distinct addresses (prepared and not) with a word to write at each,
    one more address that is left alone, and two servers on the same
    prepared keys (per-level kernels and tree kernels)."""

    def __init__(self, par, seed):
        self.par = par
        self.ctx = ctx = get_ntt_context(par.n, par.primes)
        self.src = src = rng.Source(seed)
        sk = rng.ternary_secret(src.split(), par.rank, par.n, par.xs_density,
                                device="cpu")
        self.s_ntt = s_ntt = glwe.secret_prepare(ctx, sk)
        self.ekp = keys_mod.prepare(par, keys_mod.keygen(par, sk, src))
        self.server = ram_mod.FheRam(par, self.ekp, device="cpu")
        self.tree_server = ram_mod.FheRam(par, self.ekp, device="cpu",
                                          tree_kernels=True)
        rnd = np.random.default_rng(seed + 1)
        self.data = rnd.integers(
            0, 256, size=par.max_addr * par.word_size).astype(np.uint8)
        self.state = self.server.init_state(
            ram_mod.encrypt_ram(par, ctx, s_ntt, self.data, src))
        picks = [int(i) for i in rnd.choice(par.max_addr, size=B + 1, replace=False)]
        self.idxs, self.other = picks[:B], picks[B]
        self.addrs = [address_mod.encrypt(par, ctx, s_ntt, i, src)
                      for i in picks]
        self.preps = [address_mod.prepare(ctx, a) for a in self.addrs]
        self.words = rnd.integers(0, 256, size=(B, par.word_size)).astype(np.uint8)
        self.w_b = torch.stack([
            ram_mod.encrypt_write_word(par, ctx, s_ntt, w, src)
            for w in self.words])
        self.results = {}

    def rmw(self, tree):
        """(outs, new state) of one rmw_batch of the B words, computed once
        for each of the two servers."""
        if tree not in self.results:
            server = self.tree_server if tree else self.server
            self.results[tree] = server.rmw_batch(
                self.state, stack_addresses(self.preps[:B]),
                stack_addresses(self.addrs[:B]), self.w_b)
        return self.results[tree]

    def check_word(self, out, plain, idx, note):
        par, W = self.par, self.par.word_size
        assert tuple(out.shape) == (W, par.rank + 1, par.limbs_ct, par.n), note
        for i in range(W):
            want = glwe.cast_u8_signed(int(plain[idx * W + i]), par.k_pt)
            val, noise = glwe.decode_coeff0(
                par, glwe.phase(par, self.ctx, self.s_ntt, out[i]), want)
            assert int(val) == want, f"{note} subram {i}: {val} != {want}"
            assert noise < -(par.k_pt + 1), f"{note} noise {noise}"


_clients = {}


@pytest.fixture(params=["PARAMS_TEST_FLAT", "PARAMS_TEST_3LVL"],
                ids=["flat_n2_1", "tree_n2_3"])
def client(request):
    """One client a preset for the whole file (keygen is the cost)."""
    if request.param not in _clients:
        _clients[request.param] = _Client(getattr(tparams, request.param), 21)
    return _clients[request.param]


def test_rmw_batch_reads_the_old_words_and_writes_the_new(client):
    c = client
    before = c.state.data.clone()
    outs, new_state = c.rmw(False)
    assert torch.equal(c.state.data, before), "rmw_batch must not touch the old tensor"
    assert not new_state.pending and new_state.tree == ()
    assert new_state.data.dtype == torch.int32
    assert new_state.data.shape == c.state.data.shape
    assert outs.shape[0] == B and outs.dtype == torch.int32
    plain = c.data.copy()
    W = c.par.word_size
    for k, idx in enumerate(c.idxs):
        c.check_word(outs[k], c.data, idx, f"pre-write word at {idx}")
        plain[idx * W: (idx + 1) * W] = c.words[k]
    got = c.server.read_batch(new_state, stack_addresses(c.preps))
    for k, idx in enumerate(c.idxs + [c.other]):
        c.check_word(got[k], plain, idx, f"read-back at {idx}")


def test_tree_kernels_give_the_same_integers(client):
    """rmw_batch, the single cycle and the reads with tree_kernels=True
    == the same with the per-level kernels."""
    c = client
    outs, new_state = c.rmw(False)
    outs_t, new_state_t = c.rmw(True)
    assert torch.equal(outs_t, outs)
    assert torch.equal(new_state_t.data, new_state.data)
    ap, addr = c.preps[0], c.addrs[0]
    out, pending = c.server.read_prepare_write(c.state, ap)
    out_t, pending_t = c.tree_server.read_prepare_write(c.state, ap)
    assert torch.equal(out_t, out) and len(pending_t.tree) == len(pending.tree)
    for a, b in zip(pending_t.tree, pending.tree):
        assert torch.equal(a, b)
    assert torch.equal(c.tree_server.write(pending_t, c.w_b[0], addr).data,
                       c.server.write(pending, c.w_b[0], addr).data)
    assert torch.equal(c.tree_server.read(c.state, ap), c.server.read(c.state, ap))
    both = stack_addresses(c.preps[:2])
    assert torch.equal(c.tree_server.read_batch(c.state, both),
                       c.server.read_batch(c.state, both))


def test_tree_kernels_go_through_the_tree_wrappers(client, monkeypatch):
    """With tree_kernels=True a cycle calls the one-launch wrappers where
    the geometry has a pack and an extraction, and the per-level split
    never; without, the reverse."""
    c = client
    calls = {"fused_split_tree": 0, "fused_pack_tree": 0, "fused_split": 0}
    for name in calls:
        real = getattr(ntt_cuda, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(ntt_cuda, name, spy)
    has_tree = len(c.addrs[0].coordinates) > 1
    for server in (c.tree_server, c.server):
        for name in calls:
            calls[name] = 0
        _, pending = server.read_prepare_write(c.state, c.preps[0])
        server.write(pending, c.w_b[0], c.addrs[0])
        trees = calls["fused_split_tree"], calls["fused_pack_tree"]
        if server is c.tree_server and has_tree:
            assert min(trees) > 0 and calls["fused_split"] == 0
        else:
            assert trees == (0, 0) and (calls["fused_split"] > 0) == has_tree


def test_rmw_batch_with_the_spectral_cache_and_a_batch_of_one(client):
    c = client
    outs, new_state = c.rmw(False)
    outs_c, data_c = ram_mod.rmw_batch_impl(
        c.par, c.ctx, c.state.data, stack_addresses(c.preps[:B]),
        stack_addresses(c.addrs[:B]), c.w_b, c.ekp,
        data_ntt=c.server.spectral_cache(c.state))
    assert torch.equal(outs_c, outs) and torch.equal(data_c, new_state.data)
    # a batch of one is the single cycle's plaintext: old word out, new in
    outs1, state1 = c.server.rmw_batch(
        c.state, stack_addresses(c.preps[:1]), stack_addresses(c.addrs[:1]),
        c.w_b[:1])
    c.check_word(outs1[0], c.data, c.idxs[0], "batch of one")
    plain = c.data.copy()
    W = c.par.word_size
    plain[c.idxs[0] * W: (c.idxs[0] + 1) * W] = c.words[0]
    c.check_word(c.server.read(state1, c.preps[0]), plain, c.idxs[0], "read-back")
    c.check_word(c.server.read(state1, c.preps[1]), plain, c.idxs[1], "untouched")


def test_batched_inversion_equals_the_per_address_inversion(client):
    c = client
    for j in range(len(c.addrs[0].coordinates)):
        coords_b = stack_addresses(c.addrs[:B])[j]
        got = ram_mod._invert_coordinates_batched(c.par, c.ctx, coords_b, c.ekp)
        for k in range(B):
            want = ram_mod._invert_coordinate(
                c.par, c.ctx, c.addrs[k].coordinates[j], c.ekp)
            assert got[k].shape == want.shape and torch.equal(got[k], want)


def test_rmw_batch_refuses(client):
    c = client
    preps, addrs = stack_addresses(c.preps[:B]), stack_addresses(c.addrs[:B])
    _, pending = c.server.read_prepare_write(c.state, c.preps[0])
    with pytest.raises(AssertionError):  # a write is pending
        c.server.rmw_batch(pending, preps, addrs, c.w_b)
    # tensors on another device than the server's: PyTorch's `meta` device
    # stands in for a second real device
    with pytest.raises(ValueError):
        c.server.rmw_batch(c.state, tuple(x.to("meta") for x in preps), addrs, c.w_b)
    with pytest.raises(ValueError):
        c.server.rmw_batch(c.state, preps, tuple(x.to("meta") for x in addrs), c.w_b)
    with pytest.raises(ValueError):
        c.server.rmw_batch(c.state, preps, addrs, c.w_b.to("meta"))
    with pytest.raises(ValueError):  # prepared and plain addresses in one stack
        stack_addresses([c.preps[0], c.addrs[0]])
