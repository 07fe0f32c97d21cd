"""The slices as a whole: the PyTorch port's encrypted read, its
read-modify-write cycle, its batched read and its batched
read-modify-write against the JAX package's, on the CPU, on the JAX
client's own ciphertexts.

JAX keygen, encrypt_ram, address.encrypt and encrypt_write_word at
PARAMS_TEST_SMALL (two address levels, two chained CMux digits a
coordinate, a pack tree, the full trace, a two-level split tree);
convert.from_reference carries secret, keys, RAM, addresses and the write
word across.  The port's FheRam.read equals read_impl, read_prepare_write
equals rpw_impl, write equals write_impl, read_batch equals
read_batch_impl and rmw_batch equals rmw_batch_impl bit for bit (np.array_equal; integer arithmetic,
tolerance 0), and the port's own decrypt recovers the JAX client's
plaintext under the noise bound; so do the port's row-sharded read and
read-modify-write (parallel/mesh.py).  One JAX client serves all tests of
the file, and each JAX output is computed once and read by every test that
needs it.  The other geometries are compared in
tests/test_torch_read_presets.py."""

import functools
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fhe_ram_tpu import params as jparams
from fhe_ram_tpu.ops.ntt import get_ntt_context as jget_ctx
from fhe_ram_tpu.core import glwe as jglwe
from fhe_ram_tpu.core import ggsw as jggsw
from fhe_ram_tpu.core import keys as jkeys
from fhe_ram_tpu.core import rng as jrng
from fhe_ram_tpu.ram import address as jaddress
from fhe_ram_tpu.ram import ram as jram

from fhe_ram_tpu_torch import params as tparams
from fhe_ram_tpu_torch.convert import from_reference, stack_addresses
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context as tget_ctx
from fhe_ram_tpu_torch.core import glwe as tglwe
from fhe_ram_tpu_torch.core import keys as tkeys
from fhe_ram_tpu_torch.ram import address as taddress
from fhe_ram_tpu_torch.ram import ram as tram
from fhe_ram_tpu_torch.parallel import mesh as tmesh

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


def _addresses(par):
    return [0, 1, par.max_addr // 2 + 3, par.max_addr - 1]


# the word the write tests write at the third fixture address
WRITE_WORD = np.array([0x5A, 0xC3, 0x17, 0x80], dtype=np.uint8)


def _keygen(jpar, jctx, sk, src):
    """(secret_prepare, jkeys.keygen) under one jit: the same keys and the
    same stream state as the eager calls (threefry is deterministic), in
    a third of their time (eager JAX compiles op by op)."""
    def keygen(sk, stream_keys):
        source = jrng.Source.__new__(jrng.Source)
        source._keys = stream_keys
        ek = jkeys.keygen(jpar, sk, source)
        return (jglwe.secret_prepare(jctx, sk),
                (ek.atk_glwe, ek.atk_ggsw, ek.tsk), source._keys)

    s_ntt, (atk, atk_ggsw, tsk), src._keys = _jit(keygen)(sk, src._keys)
    return s_ntt, jkeys.EvaluationKeys(atk, atk_ggsw, tsk)


@pytest.fixture(scope="module")
def client():
    """The JAX client's secret, keys, RAM and addresses, the JAX side's
    jitted server functions, and the port's server on the same
    ciphertexts."""
    jpar, tpar = jparams.PARAMS_TEST_SMALL, tparams.PARAMS_TEST_SMALL
    jctx = jget_ctx(jpar.n, jpar.primes)
    src = jrng.Source(7)
    sk = jrng.ternary_secret(src.split(), jpar.rank, jpar.n, jpar.xs_density)
    js_ntt, ek = _keygen(jpar, jctx, sk, src)
    data = np.random.default_rng(11).integers(
        0, 256, size=jpar.max_addr * jpar.word_size).astype(np.uint8)
    ram_ct = jram.encrypt_ram(jpar, jctx, js_ntt, data, src)
    addrs = {idx: jaddress.encrypt(jpar, jctx, js_ntt, idx, src)
             for idx in _addresses(jpar)}

    def prepared(atk, atk_ggsw, tsk):
        return jkeys.prepare(jpar, jkeys.EvaluationKeys(atk, atk_ggsw, tsk))

    # read_impl, rpw_impl and write_impl (of w_ct after that rpw) in ONE
    # jitted function: at this preset (no read-path truncation) the read and
    # the rpw share everything but the persisted tree, the three share the
    # key preparation, and one compile costs less than two (the write runs
    # at every address; at this size that is milliseconds)
    def read_rpw_write(d, a, w, atk, atk_ggsw, tsk):
        keys = prepared(atk, atk_ggsw, tsk)
        coords = jaddress.prepare(jctx, a).coordinates
        rpw = jram.rpw_impl(jpar, jctx, d, coords, keys.atk_glwe)
        return (jram.read_impl(jpar, jctx, d, coords, keys.atk_glwe), rpw,
                jram.write_impl(jpar, jctx, d, rpw[2], w, a.coordinates, keys))

    jread_rpw_write = _jit(read_rpw_write)
    w_ct = jram.encrypt_write_word(jpar, jctx, js_ntt,
                                   WRITE_WORD[:jpar.word_size], src)
    jkey_args = (ek.atk_glwe, ek.atk_ggsw, ek.tsk)

    tctx = tget_ctx(tpar.n, tpar.primes)
    carried = from_reference(sk=np.asarray(sk), keys=ek, ram=ram_ct, device="cpu")
    server = tram.FheRam(tpar, tkeys.prepare(tpar, carried.keys), device="cpu")
    c = SimpleNamespace(
        jpar=jpar, tpar=tpar, jctx=jctx, tctx=tctx, src=src, js_ntt=js_ntt,
        ek=ek, data=data, ram_ct=ram_ct, addrs=addrs, w_ct=w_ct,
        jkey_args=jkey_args, carried=carried, server=server,
        s_ntt=tglwe.secret_prepare(tctx, carried.sk), jresults={})

    def jax_refs(idx):
        """(read_impl output, rpw_impl output, write_impl's new RAM for
        w_ct after that rpw) at a fixture address, computed once."""
        if idx not in c.jresults:
            c.jresults[idx] = jread_rpw_write(ram_ct, addrs[idx], w_ct,
                                              *jkey_args)
        return c.jresults[idx]

    def jax_read_rpw(idx):
        return jax_refs(idx)[:2]

    def jax_write():
        """(the JAX client's write word w_ct, write_impl's new RAM) when
        WRITE_WORD is written at the third fixture address."""
        return w_ct, np.asarray(jax_refs(_addresses(jpar)[2])[2])

    def jax_read_batch():
        """read_batch_impl at the last three fixture addresses, computed once."""
        if "batch" not in c.jresults:
            idxs = _addresses(jpar)[1:]
            coords_b = tuple(
                jnp.stack([addrs[i].coordinates[j] for i in idxs], axis=0)
                for j in range(len(addrs[idxs[0]].coordinates)))
            c.jresults["batch"] = np.asarray(_jit(
                lambda d, cb, atk: jram.read_batch_impl(
                    jpar, jctx, d,
                    tuple(jax.vmap(lambda g: jggsw.prepare(jctx, g))(x) for x in cb),
                    {g: jkeys.keyswitch.key_prepare(jctx, k) for g, k in atk.items()}))(
                        ram_ct, coords_b, ek.atk_glwe))
        return c.jresults["batch"]

    def jax_rmw_batch():
        """(the words, the JAX client's write words, rmw_batch_impl's
        read-outs and new RAM) at the last two fixture addresses, computed
        once."""
        if "rmw_batch" not in c.jresults:
            idxs = _addresses(jpar)[2:]
            words = np.array([[0x5A, 0xC3, 0x17, 0x80], [0x01, 0xFE, 0x7F, 0x33]],
                             dtype=np.uint8)[:, :jpar.word_size]
            w_cts = [jram.encrypt_write_word(jpar, jctx, js_ntt, w, src)
                     for w in words]
            coords_b = tuple(
                jnp.stack([addrs[i].coordinates[j] for i in idxs], axis=0)
                for j in range(len(addrs[idxs[0]].coordinates)))
            want_outs, want_data = _jit(
                lambda d, cb, w, atk, atk_ggsw, tsk: jram.rmw_batch_impl(
                    jpar, jctx, d,
                    tuple(jax.vmap(lambda g: jggsw.prepare(jctx, g))(x) for x in cb),
                    cb, w, prepared(atk, atk_ggsw, tsk)))(
                        ram_ct, coords_b, jnp.stack(w_cts), *jkey_args)
            c.jresults["rmw_batch"] = (words, w_cts, np.asarray(want_outs),
                                       np.asarray(want_data))
        return c.jresults["rmw_batch"]

    def port_address(idx):
        """(Address, AddressPrepared) of the port for a fixture address."""
        taddr = from_reference(address=addrs[idx], device="cpu").address
        return taddr, taddress.prepare(tctx, taddr)

    def check_word(out, idx, plain):
        for i in range(tpar.word_size):
            word = tglwe.cast_u8_signed(int(plain[idx * tpar.word_size + i]),
                                        tpar.k_pt)
            val, noise = tglwe.decode_coeff0(
                tpar, tglwe.phase(tpar, tctx, c.s_ntt, out[i]), word)
            assert int(val) == word and noise < -(tpar.k_pt + 1), (idx, i)

    c.jax_read_rpw, c.jax_write = jax_read_rpw, jax_write
    c.jax_read_batch, c.jax_rmw_batch = jax_read_batch, jax_rmw_batch
    c.port_address, c.check_word = port_address, check_word
    return c


def test_from_reference_carries_the_clients_state(client):
    c = client
    assert sorted(c.carried.keys.atk_glwe) == sorted(c.ek.atk_glwe)
    assert sorted(c.carried.keys.atk_ggsw) == sorted(c.ek.atk_ggsw) == [-1]
    assert c.carried.keys.tsk.shape == c.ek.tsk.shape
    assert c.carried.data.shape == c.ram_ct.shape
    assert c.carried.address is None and c.carried.word is None
    taddr, tprep = c.port_address(0)
    assert len(taddr.coordinates) == len(c.addrs[0].coordinates) == 2
    for got, want in zip(taddr.coordinates, c.addrs[0].coordinates):
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))
    both = stack_addresses([tprep, tprep])
    assert all(b.shape == (2,) + x.shape for b, x in zip(both, tprep.coordinates))
    with pytest.raises(ValueError):
        stack_addresses([])
    with pytest.raises(RuntimeError):  # the default device is the GPU
        from_reference(sk=np.asarray(c.carried.sk))


def test_read_matches_jax_on_the_jax_clients_ciphertexts(client):
    c = client
    state = c.server.init_state(c.carried.data)
    for idx in _addresses(c.jpar):
        want = np.asarray(c.jax_read_rpw(idx)[0])
        got = c.server.read(state, c.port_address(idx)[1])
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want), f"idx={idx}"
        # and the port's own decrypt reads the JAX client's plaintext
        c.check_word(got, idx, c.data)


def test_read_prepare_write_matches_jax_on_the_jax_clients_ciphertexts(client):
    """read_prepare_write == rpw_impl: the read-out, the carried data and
    the persisted tree."""
    c = client
    for idx in _addresses(c.jpar)[2:]:
        _, (want_out, want_data, want_tree) = c.jax_read_rpw(idx)
        state = c.server.init_state(c.carried.data)
        out, pending = c.server.read_prepare_write(state, c.port_address(idx)[1])
        assert pending.pending and pending.data is state.data
        assert np.array_equal(out.numpy(), np.asarray(want_out))
        assert np.array_equal(pending.data.numpy(), np.asarray(want_data))
        assert len(pending.tree) == len(want_tree) == 1
        for got_level, want_level in zip(pending.tree, want_tree):
            assert np.array_equal(got_level.numpy(), np.asarray(want_level))
        c.check_word(out, idx, c.data)


def test_write_matches_jax_on_the_jax_clients_ciphertexts(client):
    """write == write_impl (the whole new RAM); the read-back decodes to
    the new word and two other addresses to their old ones."""
    c = client
    idx, others = _addresses(c.jpar)[2], _addresses(c.jpar)[:2]
    new_word = WRITE_WORD[:c.jpar.word_size]
    w_ct, want_new = c.jax_write()

    taddr, tprep = c.port_address(idx)
    tw = from_reference(word=w_ct, device="cpu").word
    state = c.server.init_state(c.carried.data)
    _, pending = c.server.read_prepare_write(state, tprep)
    state = c.server.write(pending, tw, taddr)
    assert not state.pending and state.tree == ()
    assert state.data.dtype == torch.int32
    assert np.array_equal(state.data.numpy(), want_new)

    plain = c.data.copy()
    plain[idx * c.jpar.word_size: (idx + 1) * c.jpar.word_size] = new_word
    c.check_word(c.server.read(state, tprep), idx, plain)
    for other in others:
        c.check_word(c.server.read(state, c.port_address(other)[1]), other, plain)


@pytest.mark.parametrize("cached", [False, True], ids=["no_cache", "spectral_cache"])
def test_read_batch_matches_jax_and_the_single_reads(client, cached):
    """read_batch of 3 addresses == read_batch_impl == three single reads,
    with the spectral cache and without (the JAX package's CPU path
    ignores its cache and recomputes: one JAX result serves both)."""
    c = client
    idxs = _addresses(c.jpar)[1:]
    want = c.jax_read_batch()

    state = c.server.init_state(c.carried.data)
    preps = [c.port_address(i)[1] for i in idxs]
    cache = c.server.spectral_cache(state) if cached else None
    got = c.server.read_batch(state, stack_addresses(preps), cache=cache)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    for k, idx in enumerate(idxs):
        single = c.server.read(state, preps[k], cache=cache)
        assert torch.equal(got[k], single)
        assert np.array_equal(single.numpy(), np.asarray(c.jax_read_rpw(idx)[0]))
        c.check_word(got[k], idx, c.data)
    # slices of 2 + 1 through the API give the same integers
    sliced = c.server.read_batch(state, stack_addresses(preps), cache=cache,
                                 batch_slice=2)
    assert torch.equal(sliced, got)


def test_rmw_batch_matches_jax_on_the_jax_clients_ciphertexts(client):
    """rmw_batch of 2 addresses == rmw_batch_impl: the read-outs and the
    whole new RAM, with the per-level kernels and with the tree kernels;
    the read-outs decode to the old words and the read-back to the new."""
    c = client
    idxs = _addresses(c.jpar)[2:]
    words, w_cts, want_outs, want_data = c.jax_rmw_batch()

    pairs = [c.port_address(i) for i in idxs]
    coeff_b = stack_addresses([a for a, _ in pairs])
    prep_b = stack_addresses([p for _, p in pairs])
    w_b = from_reference(words=w_cts, device="cpu").words
    assert w_b.shape == (2,) + tuple(np.asarray(w_cts[0]).shape)
    state = c.server.init_state(c.carried.data)
    outs, new_state = c.server.rmw_batch(state, prep_b, coeff_b, w_b)
    assert outs.dtype == torch.int32 and not new_state.pending
    assert np.array_equal(outs.numpy(), np.asarray(want_outs))
    assert np.array_equal(new_state.data.numpy(), np.asarray(want_data))
    tree_server = tram.FheRam(c.tpar, c.server.keys, device="cpu", tree_kernels=True)
    outs_t, state_t = tree_server.rmw_batch(state, prep_b, coeff_b, w_b)
    assert torch.equal(outs_t, outs) and torch.equal(state_t.data, new_state.data)

    plain = c.data.copy()
    W = c.jpar.word_size
    for k, idx in enumerate(idxs):
        c.check_word(outs[k], idx, c.data)
        plain[idx * W: (idx + 1) * W] = words[k]
    for idx in _addresses(c.jpar):
        c.check_word(c.server.read(new_state, c.port_address(idx)[1]), idx, plain)


def test_sharded_read_and_rmw_match_jax_on_the_jax_clients_ciphertexts(client):
    """The port's row-sharded paths at rows 2 on the JAX client's
    ciphertexts: sharded_read_fn with the exchange tail == read_impl on
    every shard; sharded_rmw_fn's new RAM, un-permuted, == write_impl after
    rpw_impl.  The JAX package holds its own sharded read and RMW equal to
    those two (tests/test_sharding.py:53-62, 106-131), so this holds the
    port's sharded paths to the JAX package's too."""
    c = client
    mesh = tmesh.make_mesh(2, rows=2, devices=["cpu"] * 2)
    shards = tmesh.shard_data_rows(mesh, c.carried.data)
    read = tmesh.sharded_read_fn(c.tpar, mesh, "exchange")
    for idx in _addresses(c.jpar):
        want = np.asarray(c.jax_read_rpw(idx)[0])
        outs = read(shards, c.port_address(idx)[1].coordinates,
                    c.server.keys.atk_glwe)
        assert all(np.array_equal(o.numpy(), want) for o in outs), f"idx={idx}"

    idx = _addresses(c.jpar)[2]
    w_ct, want_new = c.jax_write()
    taddr, tprep = c.port_address(idx)
    tw = from_reference(word=w_ct, device="cpu").word
    outs, new = tmesh.sharded_rmw_fn(c.tpar, mesh)(
        shards, tprep.coordinates, taddr.coordinates, tw, c.server.keys)
    assert np.array_equal(tmesh.unshard_rows(new).numpy(), want_new)
    c.check_word(outs[0], idx, c.data)


def test_composed_server_matches_jax_and_the_fused_server(client):
    """FheRam(composed=True), the composed configuration (the two-pass
    transform body; each pack merge, trace step and split level is glue
    around one fold), on the JAX client's ciphertexts: its read, read_
    prepare_write + write, read_batch and rmw_batch equal the JAX package's
    and the fused server's, bit for bit.  At this ring (n = 64) the JAX
    package takes its composed routes itself (its fused_path_active needs
    n = 4096), so this holds the port's routing to the reference's."""
    from fhe_ram_tpu_torch.ops.ntt import fused_path_active

    c = client
    cserver = tram.FheRam(c.tpar, c.server.keys, device="cpu", composed=True)
    assert not fused_path_active(cserver.ctx) and fused_path_active(c.server.ctx)
    state = c.server.init_state(c.carried.data)
    for idx in _addresses(c.jpar):
        prep = c.port_address(idx)[1]
        got = cserver.read(state, prep)
        assert np.array_equal(got.numpy(), np.asarray(c.jax_read_rpw(idx)[0])), idx
        assert torch.equal(got, c.server.read(state, prep))

    idx = _addresses(c.jpar)[2]
    w_ct, want_new = c.jax_write()
    taddr, tprep = c.port_address(idx)
    tw = from_reference(word=w_ct, device="cpu").word
    out, pending = cserver.read_prepare_write(state, tprep)
    assert np.array_equal(out.numpy(), np.asarray(c.jax_read_rpw(idx)[1][0]))
    new_state = cserver.write(pending, tw, taddr)
    assert np.array_equal(new_state.data.numpy(), want_new)
    f_out, f_pending = c.server.read_prepare_write(state, tprep)
    assert torch.equal(out, f_out)
    assert torch.equal(new_state.data, c.server.write(f_pending, tw, taddr).data)

    preps = stack_addresses([c.port_address(i)[1] for i in _addresses(c.jpar)[1:]])
    got = cserver.read_batch(state, preps)
    assert np.array_equal(got.numpy(), c.jax_read_batch())
    assert torch.equal(got, c.server.read_batch(state, preps))
    # the JAX package's MXU=0 fold refuses chained spectral input: so does
    # the composed server a cache for this preset's two-digit coordinates
    with pytest.raises(ValueError):
        cserver.read_batch(state, preps, cache=cserver.spectral_cache(state))

    _, w_cts, want_outs, want_data = c.jax_rmw_batch()
    pairs = [c.port_address(i) for i in _addresses(c.jpar)[2:]]
    coeff_b = stack_addresses([a for a, _ in pairs])
    prep_b = stack_addresses([p for _, p in pairs])
    w_b = from_reference(words=w_cts, device="cpu").words
    outs, new_state = cserver.rmw_batch(state, prep_b, coeff_b, w_b)
    assert np.array_equal(outs.numpy(), want_outs)
    assert np.array_equal(new_state.data.numpy(), want_data)
    f_outs, f_state = c.server.rmw_batch(state, prep_b, coeff_b, w_b)
    assert torch.equal(outs, f_outs) and torch.equal(new_state.data, f_state.data)
