"""The row-sharded slice of the PyTorch port (parallel/collective.py,
parallel/mesh.py) on the CPU, where every wrapper takes its plain version.

* The collectives' plain versions against the JAX package's Pallas ring
  all-gather and partner exchange in TPU interpret mode, on the virtual
  8-device CPU mesh that tests/conftest.py forces: random int32 chunks from
  a numpy seed, r in {2, 4}, every stride below r, tolerance 0.
* The strided row permutation against the JAX package's.
* Every sharded path of the port against its unsharded counterpart in the
  port, at PARAMS_TEST_SMALL (4 rows) with the port's own client: the read
  at rows 2 and 4 with both collectives, the read-modify-write and the
  rpw/write pair (rows 4 is R == n_shards: one row a shard), the batched
  read at dp 2 x rows 2 with and without the cache, the batched
  read-modify-write.  Integer arithmetic: np.array_equal / torch.equal.
  (The sharded read and write are held against the JAX package's
  read_impl / write_impl on the JAX client's ciphertexts in
  tests/test_torch_read.py.)
* The refusals: distinct cards, num_rows > N, n2 != 2, a stride that is
  not a power of two."""

import functools
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fhe_ram_tpu.parallel import collective as jcoll
from fhe_ram_tpu.parallel import mesh as jmesh

from fhe_ram_tpu_torch import params as tparams
from fhe_ram_tpu_torch.convert import stack_addresses
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context
from fhe_ram_tpu_torch.core import glwe, keys as keys_mod, rng
from fhe_ram_tpu_torch.ram import address as address_mod
from fhe_ram_tpu_torch.ram import ram as ram_mod
from fhe_ram_tpu_torch.parallel import collective as coll
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

PAR = tparams.PARAMS_TEST_SMALL
CPU = ["cpu"] * 8


def _chunks(r, seed):
    rnd = np.random.default_rng(seed)
    return rnd.integers(-(1 << 20), 1 << 20, size=(r, 2, 2, 3, 64)).astype(np.int32)


@pytest.mark.parametrize("r", [2, 4])
def test_collectives_match_jax_interpret_mode(r):
    """ring_all_gather and exchange (every stride) == the JAX package's
    Pallas kernels in interpret mode inside shard_map, bit for bit."""
    mesh = jax.make_mesh((r,), ("x",))
    x = _chunks(r, 30 + r)
    ring = _jit(jax.shard_map(
        lambda v: jcoll.ring_all_gather(v[0], "x", r, interpret=True)[None],
        mesh=mesh, in_specs=P("x"), out_specs=P("x"), check_vma=False))
    want = np.asarray(ring(jnp.asarray(x)))          # [r, r, *chunk]
    got = coll.ring_all_gather([torch.from_numpy(c) for c in x])
    assert len(got) == r
    for k in range(r):
        assert got[k].dtype == torch.int32 and np.array_equal(got[k].numpy(), want[k])
    for stride in [1 << i for i in range(r.bit_length() - 1)]:
        ex = _jit(jax.shard_map(
            lambda v, s=stride: jcoll.exchange(v[0], "x", s, r, interpret=True)[None],
            mesh=mesh, in_specs=P("x"), out_specs=P("x"), check_vma=False))
        want = np.asarray(ex(jnp.asarray(x)))
        got = coll.exchange([torch.from_numpy(c) for c in x], stride)
        for k in range(r):
            assert np.array_equal(got[k].numpy(), want[k]), (stride, k)


def test_collective_plain_versions_and_refusals():
    x = [torch.from_numpy(c) for c in _chunks(4, 3)]
    stacked = torch.stack(x)
    assert all(torch.equal(o, stacked) for o in coll.ring_all_gather(x))
    assert all(torch.equal(o, x[k ^ 2]) for k, o in enumerate(coll.exchange(x, 2)))
    one = coll.ring_all_gather(x[:1])     # one shard: nothing to gather
    assert len(one) == 1 and torch.equal(one[0], x[0][None])
    for stride in (0, 3, 4, 5):
        with pytest.raises(ValueError):
            coll.exchange(x, stride)
    with pytest.raises(ValueError):
        coll.exchange(x[:3], 2)           # 3 shards: partner 2 ^ 2 = 0, 1 ^ 2 = 3
    with pytest.raises(ValueError):
        coll.check_collective("xla")
    with pytest.raises(TypeError):
        coll.ring_all_gather([c.to(torch.int64) for c in x])
    with pytest.raises(ValueError):
        coll.ring_all_gather([x[0], x[1][:1]])
    # what the kernels are handed: a misaligned view is copied into a fresh,
    # aligned tensor; a chunk that is no whole number of 16-byte units is refused
    view = torch.arange(65, dtype=torch.int32)[1:]
    assert view.data_ptr() % 16 != 0
    ins = coll._kernel_inputs([view, view])
    assert all(i.data_ptr() % 16 == 0 and torch.equal(i, view) for i in ins)
    with pytest.raises(ValueError):
        coll._kernel_inputs([view[:6], view[:6]])
    with pytest.raises(NotImplementedError):   # chunks on distinct devices
        coll.ring_all_gather([x[0], torch.empty(x[0].shape, dtype=torch.int32,
                                                 device="meta")])


@pytest.mark.parametrize("rows,n", [(4, 2), (4, 4), (4096, 4), (64, 8)])
def test_row_shard_perm_matches_jax(rows, n):
    perm = tmesh.row_shard_perm(rows, n)
    assert np.array_equal(perm, jmesh.row_shard_perm(rows, n))
    x = torch.arange(rows * 3, dtype=torch.int32).reshape(1, rows, 3)
    mesh = tmesh.make_mesh(n, rows=n, devices=CPU[:1] * n)
    shards = tmesh.shard_data_rows(mesh, x)
    assert torch.equal(torch.cat(shards, dim=1), x[:, torch.from_numpy(perm)])
    assert torch.equal(tmesh.unshard_rows(shards), x)


@pytest.fixture(scope="module")
def world():
    """The port's own client at PARAMS_TEST_SMALL and its unsharded
    server on the CPU."""
    ctx = get_ntt_context(PAR.n, PAR.primes)
    src = rng.Source(5)
    sk = rng.ternary_secret(src.split(), PAR.rank, PAR.n, PAR.xs_density,
                            device="cpu")
    s_ntt = glwe.secret_prepare(ctx, sk)
    keys = keys_mod.prepare(PAR, keys_mod.keygen(PAR, sk, src))
    data = np.random.default_rng(23).integers(
        0, 256, size=PAR.max_addr * PAR.word_size).astype(np.uint8)
    server = ram_mod.FheRam(PAR, keys, device="cpu")
    state = server.init_state(ram_mod.encrypt_ram(PAR, ctx, s_ntt, data, src))

    def address(idx):
        coeff = address_mod.encrypt(PAR, ctx, s_ntt, idx, src)
        return coeff, address_mod.prepare(ctx, coeff)

    def word(values):
        return ram_mod.encrypt_write_word(PAR, ctx, s_ntt, values, src)

    def decodes(out, idx, plain):
        for i in range(PAR.word_size):
            want = glwe.cast_u8_signed(int(plain[idx * PAR.word_size + i]), PAR.k_pt)
            val, noise = glwe.decode_coeff0(PAR, glwe.phase(PAR, ctx, s_ntt, out[i]),
                                            want)
            assert int(val) == want and noise < -(PAR.k_pt + 1), (idx, i)

    return SimpleNamespace(ctx=ctx, keys=keys, data=data, server=server,
                           state=state, address=address, word=word,
                           decodes=decodes)


def _mesh(dp, rows):
    return tmesh.make_mesh(dp * rows, rows=rows, devices=CPU[:dp * rows])


@pytest.mark.parametrize("rows", [2, 4])
def test_sharded_read_equals_the_unsharded_read(world, rows):
    w = world
    mesh = _mesh(1, rows)
    shards = tmesh.shard_data_rows(mesh, w.state.data)
    for idx in (0, 77, PAR.max_addr - 1):
        _, prep = w.address(idx)
        want = w.server.read(w.state, prep)
        for collective in ("ring", "exchange"):
            outs = tmesh.sharded_read_fn(PAR, mesh, collective)(
                shards, prep.coordinates, w.keys.atk_glwe)
            assert len(outs) == rows
            assert all(torch.equal(o, want) for o in outs), (idx, collective)
        w.decodes(outs[0], idx, w.data)


@pytest.mark.parametrize("rows", [2, 4], ids=["rows_2", "one_row_a_shard"])
def test_sharded_write_paths_equal_rpw_and_write(world, rows):
    """sharded_rmw_fn and the sharded_rpw_fn + sharded_write_fn pair:
    the un-permuted new RAM == the unsharded read_prepare_write + write;
    the read-outs decode to the old word (the rpw's equals the unsharded
    rpw's), the new word reads back through the sharded read."""
    w = world
    mesh = _mesh(1, rows)
    shards = tmesh.shard_data_rows(mesh, w.state.data)
    idx, new_word = 141, [9, 201]
    coeff, prep = w.address(idx)
    w_ct = w.word(new_word)
    out, pending = w.server.read_prepare_write(w.state, prep)
    want = w.server.write(pending, w_ct, coeff).data

    outs, new = tmesh.sharded_rmw_fn(PAR, mesh)(
        shards, prep.coordinates, coeff.coordinates, w_ct, w.keys)
    assert len(new) == rows and torch.equal(tmesh.unshard_rows(new), want)
    assert all(torch.equal(o, outs[0]) for o in outs)
    w.decodes(outs[0], idx, w.data)
    assert torch.equal(shards[0], tmesh.shard_data_rows(mesh, w.state.data)[0])

    rpw_outs, roots = tmesh.sharded_rpw_fn(PAR, mesh)(
        shards, prep.coordinates, w.keys.atk_glwe)
    assert all(torch.equal(o, out) for o in rpw_outs)
    assert all(r.shape == (PAR.word_size, 1) + tuple(out.shape[1:]) for r in roots)
    new2 = tmesh.sharded_write_fn(PAR, mesh)(shards, roots, w_ct, coeff.coordinates,
                                             w.keys)
    assert torch.equal(tmesh.unshard_rows(new2), want)

    plain = w.data.copy()
    plain[idx * PAR.word_size: (idx + 1) * PAR.word_size] = new_word
    back = tmesh.sharded_read_fn(PAR, mesh)(new, prep.coordinates, w.keys.atk_glwe)
    w.decodes(back[0], idx, plain)


def test_batched_paths_equal_the_unsharded_batch(world):
    """At dp 2 x rows 2: batched_read_fn with and without the cache (in
    slices of one address) == read_batch_impl; batched_rmw_fn ==
    rmw_batch_impl on the read-outs and the whole new RAM."""
    w = world
    mesh = _mesh(2, 2)
    shards = tmesh.shard_data_rows(mesh, w.state.data)
    pairs = [w.address(i) for i in (3, 64, 130, 250)]
    prep_b = stack_addresses([p for _, p in pairs])
    coeff_b = stack_addresses([c for c, _ in pairs])
    atk = w.keys.atk_glwe
    want = ram_mod.read_batch_impl(PAR, w.ctx, w.state.data, prep_b, atk)
    cache = tmesh.sharded_spectral_cache_fn(PAR, mesh)(shards)
    for with_cache in (False, True):
        fn = tmesh.batched_read_fn(PAR, mesh, with_cache=with_cache, batch_slice=1)
        outs = fn(shards, tmesh.shard_addr_batch(mesh, prep_b), atk,
                  cache if with_cache else None)
        assert len(outs) == 2 and all(len(o) == 2 for o in outs)
        for k in range(2):
            assert torch.equal(torch.cat([o[k] for o in outs]), want), with_cache
    with pytest.raises(ValueError):       # a cache the function was not built for
        tmesh.batched_read_fn(PAR, mesh)(shards, tmesh.shard_addr_batch(mesh, prep_b),
                                         atk, cache)

    words = torch.stack([w.word([i, 255 - i]) for i in range(4)])
    want_outs, want_data = ram_mod.rmw_batch_impl(PAR, w.ctx, w.state.data, prep_b,
                                                  coeff_b, words, w.keys)
    keys = tmesh.replicated(mesh, w.keys)      # on the mesh's one device
    assert keys.tsk is w.keys.tsk and keys.atk_glwe[3] is w.keys.atk_glwe[3]
    outs, new = tmesh.batched_rmw_fn(PAR, mesh)(
        shards, tmesh.shard_addr_batch(mesh, prep_b),
        tmesh.shard_addr_batch(mesh, coeff_b), tmesh.shard_addr_batch(mesh, words),
        keys)
    for k in range(2):
        assert torch.equal(torch.cat([o[k] for o in outs]), want_outs)
    assert torch.equal(tmesh.unshard_rows(new), want_data)


def test_mesh_refusals():
    with pytest.raises(NotImplementedError, match="distinct"):
        tmesh.make_mesh(2, rows=2, devices=["cuda:0", "cuda:1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # the default device is the card
            tmesh.make_mesh(2, rows=2)
    with pytest.raises(ValueError):
        tmesh.make_mesh(4, rows=3, devices=CPU)
    mesh = _mesh(1, 2)
    big = tparams.PARAMS_TEST_3LVL                       # 128 rows > N = 64
    assert big.num_rows > big.n
    with pytest.raises(ValueError, match="one pack chunk"):
        tmesh.sharded_read_fn(big, mesh)
    with pytest.raises(ValueError, match="n2 = 1"):
        tmesh.sharded_rmw_fn(tparams.PARAMS_TEST_FLAT, mesh)
    with pytest.raises(ValueError):
        tmesh.sharded_rmw_fn(PAR, mesh, collective="xla")
    with pytest.raises(ValueError):
        tmesh.sharded_read_fn(PAR, _mesh(1, 8))          # 8 shards of 4 rows
    with pytest.raises(ValueError):
        tmesh.shard_addr_batch(_mesh(2, 1), torch.zeros(3, 1))
