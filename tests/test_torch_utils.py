"""The PyTorch port's core/noise.py and utils/ against the JAX package's:
the analytic noise model value for value at every preset, the GGSW noise
measurement on the same ciphertext, checkpoint files written by either
package and loaded by the other, and the timing helpers on the CPU.

The reference's noise model is plain Python and its checkpoint functions
are numpy; its GGSW measurement runs once at a log_n = 6 preset, with its
phase and transforms jitted (the same integer operations, compiled whole
instead of op by op)."""

import dataclasses
import functools
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fhe_ram_tpu import params as jparams
from fhe_ram_tpu.core import keys as jkeys
from fhe_ram_tpu.core import noise as jnoise
from fhe_ram_tpu.ops import ntt as jntt
from fhe_ram_tpu.ops.ntt import get_ntt_context as jget_ctx
from fhe_ram_tpu.ram import address as jaddress
from fhe_ram_tpu.ram import ram as jram
from fhe_ram_tpu.utils import io as jio

from fhe_ram_tpu_torch import params as tparams
from fhe_ram_tpu_torch.core import ggsw as tggsw
from fhe_ram_tpu_torch.core import glwe as tglwe
from fhe_ram_tpu_torch.core import keys as tkeys
from fhe_ram_tpu_torch.core import noise as tnoise
from fhe_ram_tpu_torch.core import rng as trng
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context as tget_ctx
from fhe_ram_tpu_torch.ram import address as taddress
from fhe_ram_tpu_torch.ram import ram as tram
from fhe_ram_tpu_torch.utils import io as tio
from fhe_ram_tpu_torch.utils import profiling as tprofiling

torch.set_num_threads(1)

# The JAX reference is compiled without XLA's optimisation passes, in one
# piece and with XLA:CPU's loop emitters (its fusion emitters compile on
# several threads): the integers are the same, and the compile takes less
# CPU time.
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_cpu_parallel_codegen_split_count": 1,
    "xla_cpu_use_fusion_emitters": False})

PRESETS = sorted(name for name in dir(jparams) if name.startswith("PARAMS_"))


@pytest.mark.parametrize("name", PRESETS)
def test_noise_model_equals_the_reference(name):
    """Every function of the analytic model that takes only Params, and the
    building blocks at the preset's own limb counts: the same floats."""
    jp, tp = getattr(jparams, name), getattr(tparams, name)
    for fn in ("read_noise_log2", "write_cycle_added_var", "refresh_budget",
               "vm_trunc_added_log2", "bitdecomp_bit_noise_log2"):
        assert getattr(tnoise, fn)(tp) == getattr(jnoise, fn)(jp), fn
    L, Lg = jp.limbs_ct, jp.limbs_ggsw
    assert tnoise.var_fresh(tp, L) == jnoise.var_fresh(jp, L)
    assert (tnoise.var_external_product(tp, L, tnoise.var_fresh(tp, Lg), L)
            == jnoise.var_external_product(jp, L, jnoise.var_fresh(jp, Lg), L))
    assert (tnoise.var_keyswitch(tp, L, tp.limbs_evk_trace, L)
            == jnoise.var_keyswitch(jp, L, jp.limbs_evk_trace, L))
    for trunc in ((None, None), jp.read_ks_trunc):
        assert (tnoise.trace_noise(tp, 1e-30, L, trunc=trunc)
                == jnoise.trace_noise(jp, 1e-30, L, trunc=trunc))
        assert (tnoise.packer_noise(tp, 1e-30, L, 64, trunc=trunc)
                == jnoise.packer_noise(jp, 1e-30, L, 64, trunc=trunc))
    assert (tnoise.conversion_ggsw_row_var(tp, 5)
            == jnoise.conversion_ggsw_row_var(jp, 5))
    assert tnoise.bound_log2(1e-20, 1e-12) == jnoise.bound_log2(1e-20, 1e-12)


def _port_client(par, seed=3):
    ctx = tget_ctx(par.n, par.primes)
    src = trng.Source(seed)
    sk = trng.ternary_secret(src.split(), par.rank, par.n, par.xs_density,
                             device="cpu")
    return ctx, src, sk, tglwe.secret_prepare(ctx, sk)


def test_ggsw_noise_measurement_equals_the_reference():
    """The port's measurement of a GGSW it encrypted == the reference's
    measurement of the same integers under the same secret; a fresh GGSW
    passes the analytic bound and fails an absurd one."""
    par, jpar = tparams.PARAMS_TEST_SMALL_WIDE, jparams.PARAMS_TEST_SMALL_WIDE
    ctx, src, sk, s_ntt = _port_client(par)
    mono = np.zeros(par.n, dtype=np.int32)
    mono[5] = -1
    g = tggsw.encrypt(par, ctx, s_ntt, mono, src)
    got = tnoise.ggsw_noise_log2(par, ctx, sk, s_ntt, g, mono)
    assert got.shape == (par.dnum_ct, par.rank + 1)

    from fhe_ram_tpu.core import glwe as jglwe
    jctx = jget_ctx(jpar.n, jpar.primes)
    jsk = jnp.asarray(sk.numpy())
    # the measurement's device work jitted: eager JAX compiles every
    # operation apart (~3x the time)
    with mock.patch.object(jglwe, "phase", _jit(jglwe.phase, static_argnums=(0, 1))), \
            mock.patch.object(jntt, "ntt_fwd", _jit(jntt.ntt_fwd, static_argnums=(0,))), \
            mock.patch.object(jntt, "ntt_inv", _jit(jntt.ntt_inv, static_argnums=(0,))):
        want = jnoise.ggsw_noise_log2(
            jpar, jctx, jsk, _jit(lambda s: jglwe.secret_prepare(jctx, s))(jsk),
            jnp.asarray(g.numpy()), mono)
    assert np.array_equal(got, want)

    bound = tnoise.bound_log2(tnoise.var_fresh(par, par.limbs_ggsw))
    measured = tnoise.assert_ggsw_noise(par, ctx, sk, s_ntt, g, torch.from_numpy(mono),
                                        bound)
    assert np.array_equal(measured, got)
    with pytest.raises(AssertionError):
        tnoise.assert_ggsw_noise(par, ctx, sk, s_ntt, g, mono, -200.0)


def _random_state(par, seed=9):
    """Random int32 arrays of the preset's key, RAM, tree and address shapes."""
    rnd = np.random.default_rng(seed)
    C = par.rank + 1

    def limbs(*shape):
        return rnd.integers(-(1 << 16), 1 << 16, size=shape).astype(np.int32)

    atk = {g: limbs(par.dnum_ct, par.rank, C, par.limbs_evk_trace, par.n)
           for g in par.trace_gal_els}
    atkg = {-1: limbs(par.dnum_ggsw, par.rank, C, par.limbs_evk_ggsw, par.n)}
    tsk = limbs(par.rank, par.dnum_ggsw, C, C, par.limbs_evk_ggsw, par.n)
    data = limbs(par.word_size, par.num_rows, C, par.limbs_ct, par.n)
    tree = (limbs(par.word_size, 1, C, par.limbs_ct, par.n),)
    coords = tuple(limbs(len(b.bases), par.dnum_ct, C, C, par.limbs_ggsw, par.n)
                   for b in par.base2d().rows)
    return atk, atkg, tsk, data, tree, coords


def _same(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    return a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_load_across_the_packages(tmp_path, writer):
    """Keys, a pending RAM state and an address written by one package load
    in the other, arrays equal; mismatched Params are refused by both."""
    tpar, jpar = tparams.PARAMS_TEST_SMALL, jparams.PARAMS_TEST_SMALL
    atk, atkg, tsk, data, tree, coords = _random_state(tpar)
    t = torch.from_numpy
    paths = {k: str(tmp_path / f"{k}.npz") for k in ("keys", "ram", "addr")}
    if writer == "port":
        tio.save_keys(paths["keys"], tpar, tkeys.EvaluationKeys(
            {g: t(k) for g, k in atk.items()}, {g: t(k) for g, k in atkg.items()},
            t(tsk)))
        tio.save_ram_state(paths["ram"], tpar, t(data), tuple(t(x) for x in tree))
        tio.save_address(paths["addr"], tpar,
                         taddress.Address(tuple(t(c) for c in coords)))
        keys = jio.load_keys(paths["keys"], jpar)
        got_data, got_tree = jio.load_ram_state(paths["ram"], jpar)
        addr = jio.load_address(paths["addr"], jpar)
        other, other_par = jio, dataclasses.replace(jpar, k_pt=jpar.k_pt + 1)
        refusals = [lambda: other.load_keys(paths["keys"], other_par),
                    lambda: other.load_ram_state(paths["ram"], other_par),
                    lambda: other.load_address(paths["addr"], other_par)]
    else:
        jio.save_keys(paths["keys"], jpar, jkeys.EvaluationKeys(
            {g: jnp.asarray(k) for g, k in atk.items()},
            {g: jnp.asarray(k) for g, k in atkg.items()}, jnp.asarray(tsk)))
        jio.save_ram_state(paths["ram"], jpar, jnp.asarray(data),
                           tuple(jnp.asarray(x) for x in tree))
        jio.save_address(paths["addr"], jpar,
                         jaddress.Address(tuple(jnp.asarray(c) for c in coords)))
        keys = tio.load_keys(paths["keys"], tpar, device="cpu")
        got_data, got_tree = tio.load_ram_state(paths["ram"], tpar, device="cpu")
        addr = tio.load_address(paths["addr"], tpar, device="cpu")
        other_par = dataclasses.replace(tpar, k_pt=tpar.k_pt + 1)
        refusals = [lambda: tio.load_keys(paths["keys"], other_par, device="cpu"),
                    lambda: tio.load_ram_state(paths["ram"], other_par, device="cpu"),
                    lambda: tio.load_address(paths["addr"], other_par, device="cpu")]
        with pytest.raises(RuntimeError):  # the default device is the GPU
            tio.load_keys(paths["keys"], tpar)
    assert sorted(keys.atk_glwe) == sorted(atk) and sorted(keys.atk_ggsw) == [-1]
    assert all(_same(keys.atk_glwe[g], atk[g]) for g in atk)
    assert _same(keys.atk_ggsw[-1], atkg[-1]) and _same(keys.tsk, tsk)
    assert _same(got_data, data) and len(got_tree) == 1 and _same(got_tree[0], tree[0])
    assert len(addr.coordinates) == len(coords)
    assert all(_same(a, b) for a, b in zip(addr.coordinates, coords))
    for refuse in refusals:
        with pytest.raises(ValueError):
            refuse()
    # without Params to hold against, a load checks nothing
    assert _same(tio.load_ram_state(paths["ram"], device="cpu")[0], data)


@pytest.mark.parametrize("name", ["PARAMS_TEST_SMALL", "PARAMS_TEST_3LVL"])
def test_make_tree_matches_the_reference_and_round_trips(tmp_path, name):
    """ram.make_tree: the JAX package's level shapes and dtype, zeros on
    the device asked for (the GPU by default), and a state with it saved
    and loaded whole."""
    tpar, jpar = getattr(tparams, name), getattr(jparams, name)
    tree = tram.make_tree(tpar, device="cpu")
    want = jram.make_tree(jpar)
    assert [tuple(t.shape) for t in tree] == [tuple(w.shape) for w in want]
    assert len(tree) == len(tpar.tree_shape()) >= 1
    assert all(t.dtype == torch.int32 and not t.any() for t in tree)
    assert all(np.asarray(w).dtype == np.int32 for w in want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tram.make_tree(tpar)
    data = torch.arange(tpar.word_size * tpar.num_rows * (tpar.rank + 1)
                        * tpar.limbs_ct * tpar.n, dtype=torch.int32).reshape(
        tpar.word_size, tpar.num_rows, tpar.rank + 1, tpar.limbs_ct, tpar.n)
    path = str(tmp_path / "state.npz")
    tio.save_ram_state(path, tpar, data, tree)
    got_data, got_tree = tio.load_ram_state(path, tpar, device="cpu")
    assert torch.equal(got_data, data) and len(got_tree) == len(tree)
    assert all(torch.equal(a, b) for a, b in zip(got_tree, tree))


def test_timing_and_noise_helpers(tmp_path):
    par = tparams.PARAMS_TEST_SMALL_WIDE
    ctx, src, sk, s_ntt = _port_client(par, seed=4)
    calls = []
    secs = tprofiling.synced_time(lambda x: calls.append(x), 1, repeats=2)
    assert secs >= 0.0 and calls == [1, 1, 1]   # one warm-up, two timed
    vals = np.zeros(par.n, dtype=np.int32)
    vals[0] = 3
    ct = tglwe.encrypt(par, ctx, s_ntt, tglwe.encode_vec(par, vals, device="cpu"), src)
    rep = tprofiling.noise_report(par, ctx, s_ntt, ct, 3)
    assert rep["value"] == 3 and rep["noise_log2"] < -(par.k_pt + 1)
    assert rep["budget_log2"] == pytest.approx(-(par.k_pt + 1) - rep["noise_log2"])
    with tprofiling.trace_to(str(tmp_path / "trace")) as prof:
        tglwe.phase(par, ctx, s_ntt, ct)
    assert len(prof.key_averages()) > 0
    assert any((tmp_path / "trace").iterdir())
