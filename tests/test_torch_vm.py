"""The VM slice of the PyTorch port held against the JAX package, on the
CPU: every module of the slice that holds a kernel, bit for bit, on both
of the port's routes -- the fused one (a radix-2 context: kernels 9-11) and
the composed one (a two-pass context: loops of CMuxes, the JAX package's
FHERAM_MXU=0 branches, which are what it runs on a CPU).

Inputs are random int32 arrays of the right shapes made with numpy from a
seed -- bit GGSWs, words, trace keys -- each side preparing its own
spectra (spectral arrays are never compared).  No keygen, no encryption:
the integer functions are the same whatever the arrays hold.  The JAX side
is three jitted functions, two at one ring and one at the other (their
compile is what these tests cost; they compile side by side, in two
threads, each external product and keyswitch traced once a shape):

* an untruncated ring (PARAMS_TEST_SMALL, log_n = 6): eval_ops + select_rd
  over ("none", "add", "xor", "srai", "sll", "srl") at 2 bits (kernels 11,
  9 and 10, and the shift group: word_from_bits, the slot extraction and
  one keyed barrel level over an immediate group of one op zero-padded to
  the register group's two), the pointer conversion (kernel 10 over D*C
  rows), the byte repack, select_store's two blind rotations (which the
  port runs as ONE 4-step launch, and which glwe_blind_rotation computes
  alone), its splices and its test vector (from given slot stacks: the
  slot extraction is stubbed on both sides, it is held above);
* a READOPT-style truncated ring: the carry-DP group at 4 bits over
  ("addi", "sub", "slt") (emit, subtract table, MSB flip; immediate and
  register groups of unequal size, zero-padded on the JAX side), the bitwise
  group, and the truncated blind rotation, held against a loop of truncated
  keyed CMuxes over rotated rows -- the semantics the port has at every
  ring degree and the JAX package only on its fused path (ROADMAP.md
  section 3); and glwe_blind_rotation and select_rd (2-bit op id, 16-bit
  words: a 2-step partial trace), which the JAX package runs composed,
  with the full gadget, as the port's two-pass route does.

Every comparison is np.array_equal on int32 tensors (integer arithmetic,
tolerance 0).  The whole cycle decodes on the port alone in
tests/test_torch_vm_cycle.py."""

import contextlib
import functools
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import jax
import pytest
import torch

from fhe_ram_tpu.params import Params as JParams
from fhe_ram_tpu.params import PARAMS_TEST_SMALL as JSMALL
from fhe_ram_tpu.ops.ntt import get_ntt_context as jget_ctx
from fhe_ram_tpu.ops import poly as jpoly
from fhe_ram_tpu.core import ggsw as jggsw
from fhe_ram_tpu.core import keyswitch as jks
from fhe_ram_tpu.vm import arithmetic as jar
from fhe_ram_tpu.vm import circuits as jcirc
from fhe_ram_tpu.vm import conversion as jconv
from fhe_ram_tpu.vm import cycle as jcycle
from fhe_ram_tpu.vm import store as jstore

from fhe_ram_tpu_torch.convert import from_reference
from fhe_ram_tpu_torch.params import Params as TParams
from fhe_ram_tpu_torch.params import PARAMS_TEST_SMALL as TSMALL
from fhe_ram_tpu_torch.ops.ntt import get_ntt_context as tget_ctx
from fhe_ram_tpu_torch.core import ggsw as tggsw
from fhe_ram_tpu_torch.core import keyswitch as tks
from fhe_ram_tpu_torch.vm import arithmetic as tar
from fhe_ram_tpu_torch.vm import conversion as tconv
from fhe_ram_tpu_torch.vm import cycle as tcycle
from fhe_ram_tpu_torch.vm import store as tstore

# one intra-op thread: the suite runs several workers side by side, and
# these sizes gain nothing from more
torch.set_num_threads(1)

# The JAX reference is compiled without XLA's optimisation passes, in one
# piece and with XLA:CPU's loop emitters (its fusion emitters compile on
# several threads): the integers are the same, these sizes run in no time
# either way, and the compile takes less CPU time (the suite's workers
# share their cores, so CPU time is what the whole run pays for).
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_cpu_parallel_codegen_split_count": 1,
    "xla_cpu_use_fusion_emitters": False})

BITS = 4                       # word bits of the truncated groups
ALU_BITS = 2                   # word bits of eval_ops + select_rd (gap 32)
OPS = ("none", "add", "xor", "srai", "sll", "srl")
SPLICES = ((0, 1), (0, 2), (1, 1), (2, 1), (2, 2), (3, 1))
TRUNC = dict(log_n=6, k_pt=3, decomp_n=(6,), word_size=2, max_addr=1 << 8,
             read_ks_digits=2, read_ks_limbs=3, read_ep_digits=2,
             read_ep_limbs=3)
DP_OPS = ("addi", "sub", "slt")
BW_OPS = ("xori", "and", "or")
BROT_AMOUNTS = (-1, -2, -4)
SEL_OPS, SEL_BITS = 4, 16     # select_rd at the truncated ring: 2 rotation bits
BODIES = ("radix2", "two_pass")   # the fused routes, the composed routes


def _t(a):
    return torch.from_numpy(np.array(a))   # a writable copy


def _body_ctx(par, body):
    return tget_ctx(par.n, par.primes, body)


def _eq(got, want):
    """The port's int32 tensor holds the JAX array's integers."""
    return got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


class _Inputs:
    """Random arrays of the shapes a ring's VM functions take."""

    def __init__(self, par, seed):
        self.rnd = np.random.default_rng(seed)
        self.par = par
        self.C, self.L, self.n = par.rank + 1, par.limbs_ct, par.n

    def limbs(self, shape, bits=16):
        return self.rnd.integers(-(1 << bits), 1 << bits, size=shape).astype(np.int32)

    def bits(self, count, dnum=None, limbs=None):
        """Coefficient-domain bit GGSWs [W, D, C, C2, Lg, N]."""
        p = self.par
        return self.limbs((count, dnum or p.dnum_ct, self.C, self.C,
                           limbs or p.limbs_ggsw, self.n))

    def word(self, *lead):
        return self.limbs(lead + (self.C, self.L, self.n))

    def trace_keys(self):
        p = self.par
        return {g: self.limbs((p.dnum_ct, p.rank, self.C, p.limbs_evk_trace, self.n))
                for g in p.trace_gal_els}


def _jprep_keys(jctx, keys):
    return {g: jks.key_prepare(jctx, k) for g, k in keys.items()}


def _tprep_keys(tctx, keys):
    return {g: tks.key_prepare(tctx, _t(k)) for g, k in keys.items()}


# ---------------------------------------------------------------------------
# the untruncated ring: eval_ops + select_rd, conversion, repack, store
# ---------------------------------------------------------------------------

def _trace_once():
    """A context in which every external product and keyswitch of the JAX
    package is a jit of its own inside the reference's jit: the many calls
    of one shape are traced once (the same integers; a third of the
    tracing, which is most of the compile's time here)."""
    stack = contextlib.ExitStack()
    for mod, name, static in ((jggsw, "external_product_keyed", (0, 1, 4, 6, 7, 8)),
                              (jggsw, "external_product_batched", (0, 1, 4, 6, 7)),
                              (jks, "keyswitch", (0, 1, 4, 6, 7))):
        stack.enter_context(mock.patch.object(
            mod, name, jax.jit(getattr(mod, name), static_argnums=static)))
    return stack


@pytest.fixture(scope="module")
def jax_refs():
    """The references, compiled in two threads side by side: XLA compiles
    outside the interpreter lock while the other thread traces (less wall
    time; a third thread measured no faster and cost more CPU time)."""
    x = _small_inputs()
    with _trace_once(), ThreadPoolExecutor(2) as pool:
        alu = pool.submit(_small_alu_reference, x)
        rest = pool.submit(_small_rest_reference, x)
        truncated = pool.submit(_truncated_reference)
        small = (TSMALL, tget_ctx(TSMALL.n, TSMALL.primes), x,
                 {**alu.result(), **rest.result()})
        return {"small": small, "truncated": (*_truncated_inputs(), truncated.result())}


@pytest.fixture(scope="module")
def small(jax_refs):
    return jax_refs["small"]


@pytest.fixture(scope="module")
def truncated(jax_refs):
    return jax_refs["truncated"]


JCTX = jget_ctx(JSMALL.n, JSMALL.primes)


def _small_inputs():
    par = JSMALL
    inp = _Inputs(par, 41)
    log_ops = (len(OPS) - 1).bit_length()
    ptr_bits = par.max_addr.bit_length() - 1
    return dict(
        rs1=inp.bits(ALU_BITS), rs2=inp.bits(ALU_BITS), imm=inp.bits(ALU_BITS),
        op_id=inp.bits(log_ops), word=inp.word(), atk=inp.trace_keys(),
        ptr=inp.bits(ptr_bits, par.dnum_ggsw, par.limbs_evk_ggsw),
        store_res=inp.word(), offset=inp.bits(2),
        sop=inp.bits(2), y_slots=inp.word(32), x_slots=inp.word(32),
        store_x=inp.word(), store_y=inp.word())


def _jpr(b):
    return jggsw.prepare(JCTX, b)


def _small_alu_reference(x):
    def jax_side(x):
        atk = _jprep_keys(JCTX, x["atk"])
        packed = jar.eval_ops(JSMALL, JCTX, _jpr(x["rs1"]), _jpr(x["rs2"]),
                              _jpr(x["imm"]), atk, OPS, ALU_BITS)
        rd = jar.select_rd(JSMALL, JCTX, packed, _jpr(x["op_id"]), len(OPS), atk,
                           ALU_BITS)
        return dict(packed=packed, rd=rd)

    return jax.tree_util.tree_map(np.asarray, _jit(jax_side)(x))


def _small_rest_reference(x):
    par = JSMALL

    def jax_side(x):
        atk = _jprep_keys(JCTX, x["atk"])
        addr, _ = jconv.fheuint_to_address(par, JCTX, _jpr(x["ptr"]))
        wbytes = jcycle.word_to_ram_bytes(par, JCTX, x["word"], atk, 8)
        res = jar.glwe_blind_rotation(par, JCTX, x["store_res"], _jpr(x["offset"]),
                                      0, 2, lsh=2)
        res = jar.glwe_blind_rotation(par, JCTX, res, _jpr(x["sop"]), 0, 2, lsh=0)
        splices = [jstore._splice(par, x["y_slots"], x["x_slots"], b, w, 32)
                   for b, w in SPLICES]
        # the JAX package's case table over the given (traced) slot stacks
        with mock.patch.object(jcirc, "extract_slots",
                               _given_slots(x, jcirc.extract_slots)):
            vector = jstore.construct_store_test_vector(par, JCTX, x["store_x"],
                                                        x["store_y"], {}, 32)
        return dict(coords=addr.coordinates, wbytes=wbytes, store_rot=res,
                    splices=splices, store_vector=vector,
                    prepared={k: _jpr(x[k]) for k in ("rs1", "ptr")})

    return jax.tree_util.tree_map(np.asarray, _jit(jax_side)(x))


def _given_slots(x, extract_slots):
    """extract_slots, but the random slot stacks of x for the two words of
    select_store's test vector: x_slots for the stored word, y_slots for
    the loaded one (other words, as another thread's, go to the real one)."""
    def given(params, ctx, word, atk, bits=32, trunc=(None, None)):
        if word is x["store_x"]:
            return x["x_slots"]
        if word is x["store_y"]:
            return x["y_slots"]
        return extract_slots(params, ctx, word, atk, bits, trunc)
    return given


def _tprep(tctx, b):
    return tggsw.prepare(tctx, _t(b))


@pytest.mark.parametrize("body", BODIES)
def test_eval_ops_and_select_rd_match_jax(small, body):
    """Kernels 11 (add), 9 (xor) and 10 (select_rd's rotation), or their
    composed loops, and the shift group (srai against sll and srl: unequal
    source groups, the immediate one zero-padded), in the packed ALU result
    and the selected rd."""
    par, _, x, want = small
    tctx = _body_ctx(par, body)
    atk = _tprep_keys(tctx, x["atk"])
    packed = tar.eval_ops(par, tctx, _tprep(tctx, x["rs1"]), _tprep(tctx, x["rs2"]),
                          _tprep(tctx, x["imm"]), atk, OPS, ALU_BITS)
    assert _eq(packed, want["packed"])
    rd = tar.select_rd(par, tctx, packed, _tprep(tctx, x["op_id"]), len(OPS), atk,
                       ALU_BITS)
    assert _eq(rd, want["rd"])


def test_from_reference_carries_the_vm_operands(small):
    """The JAX client's prepared bits (its spectra) become the port's
    canonical residues of the same transform; a word goes as it is."""
    par, tctx, x, want = small
    vm = from_reference(vm={"rs1p": want["prepared"]["rs1"], "word": x["word"],
                            "ptr_prep": want["prepared"]["ptr"]}, device="cpu").vm
    assert torch.equal(vm["rs1p"], _tprep(tctx, x["rs1"]))
    assert torch.equal(vm["ptr_prep"], _tprep(tctx, x["ptr"]))
    assert _eq(vm["word"], x["word"])
    with pytest.raises(ValueError):      # spectra need the prime axis
        from_reference(vm={"b": want["prepared"]["rs1"][:2]}, device="cpu")


@pytest.mark.parametrize("body", BODIES)
def test_fheuint_to_address_matches_jax(small, body):
    """Both coordinates of the converted pointer (three blind rotations of
    D*C rows, one with lsh = 3: kernel 10, or one keyed CMux a bit) from
    the JAX client's prepared pointer carried across, and the prepared form
    is the port's prepare of them."""
    par, _, x, want = small
    tctx = _body_ctx(par, body)
    ptr = from_reference(vm={"ptr": want["prepared"]["ptr"]}, device="cpu").vm["ptr"]
    addr, prep = tconv.fheuint_to_address(par, tctx, ptr)
    assert len(addr.coordinates) == len(want["coords"]) == 2
    for got, ref, gp in zip(addr.coordinates, want["coords"], prep.coordinates):
        assert _eq(got, ref)
        assert torch.equal(gp, tggsw.prepare(tctx, _t(ref)))


@pytest.mark.parametrize("body", BODIES)
def test_word_to_ram_bytes_matches_jax(small, body):
    par, _, x, want = small
    tctx = _body_ctx(par, body)
    got = tcycle.word_to_ram_bytes(par, tctx, _t(x["word"]),
                                   _tprep_keys(tctx, x["atk"]), 8)
    assert got.shape == (1,) + tuple(x["word"].shape)
    assert _eq(got, want["wbytes"])


@pytest.mark.parametrize("route", ("store_rotation", "glwe_blind_rotation"))
@pytest.mark.parametrize("body", BODIES)
def test_store_rotations_match_jax(small, body, route):
    """JAX's two rotations, offset << 2 then op, untruncated, against the
    port's store_rotation (ONE 4-step launch (-4, -8, -1, -2), or the two
    composed rotations) and against the port's glwe_blind_rotation called
    twice as JAX calls it."""
    par, _, x, want = small
    tctx = _body_ctx(par, body)
    res, off, sop = (_t(x["store_res"]), _tprep(tctx, x["offset"]),
                     _tprep(tctx, x["sop"]))
    if route == "store_rotation":
        got = tstore.store_rotation(par, tctx, res, off, sop)
    else:
        got = tar.glwe_blind_rotation(par, tctx, res, off, 0, 2, lsh=2)
        got = tar.glwe_blind_rotation(par, tctx, got, sop, 0, 2, lsh=0)
    assert _eq(got, want["store_rot"])


def test_store_test_vector_matches_jax(small, monkeypatch):
    """construct_store_test_vector's case table (one gather, one
    normalize) against the JAX package's (add, normalize, rotate case by
    case), both from the same slot stacks."""
    par, tctx, x, want = small
    xt = {k: _t(x[k]) for k in ("store_x", "store_y", "x_slots", "y_slots")}
    monkeypatch.setattr(tstore.circuits, "extract_slots",
                        _given_slots(xt, tstore.circuits.extract_slots))
    got = tstore.construct_store_test_vector(par, tctx, xt["store_x"], xt["store_y"],
                                             {}, 32)
    assert _eq(got, want["store_vector"])


@pytest.mark.parametrize("case", range(len(SPLICES)),
                         ids=[f"byte{b}_width{w}" for b, w in SPLICES])
def test_splice_matches_jax(small, case):
    par, tctx, x, want = small
    b, w = SPLICES[case]
    got = tstore._splice(par, _t(x["y_slots"]), _t(x["x_slots"]), b, w, 32)
    assert _eq(got, want["splices"][case])


# ---------------------------------------------------------------------------
# the truncated ring: the DP and bitwise groups, the truncated rotation
# ---------------------------------------------------------------------------

def _truncated_x():
    """The truncated ring's random inputs, from their seed."""
    par = JParams(**TRUNC)
    inp = _Inputs(par, 43)
    sel_gals = par.trace_gal_els[:par.log_n - (SEL_BITS.bit_length() - 1)]
    return dict(rs1=inp.bits(BITS), rs2=inp.bits(BITS), imm=inp.bits(BITS),
                rows=inp.word(2), rot_bits=inp.bits(len(BROT_AMOUNTS)),
                atk={g: k for g, k in inp.trace_keys().items() if g in sel_gals})


def _truncated_inputs():
    """The port's side of the truncated ring: (params, context, inputs,
    prepared bits)."""
    par_t = TParams(**TRUNC)
    tctx = tget_ctx(par_t.n, par_t.primes)
    x = _truncated_x()
    prep = {k: _tprep(tctx, x[k]) for k in ("rs1", "rs2", "imm", "rot_bits")}
    return par_t, tctx, x, prep


def _truncated_reference():
    par_j = JParams(**TRUNC)
    jctx = jget_ctx(par_j.n, par_j.primes)
    x = _truncated_x()
    ept = jar._vm_trunc(par_j, BITS)[0]
    assert ept == (2, 3)

    def jax_side(x):
        pr = lambda b: jggsw.prepare(jctx, b)
        rs1, rs2, imm = pr(x["rs1"]), pr(x["rs2"]), pr(x["imm"])
        dp = jar._dp_group(par_j, jctx, DP_OPS, rs1, rs2, imm, BITS)
        bw = jar._bitwise_group(par_j, jctx, BW_OPS, rs1, rs2, imm, BITS)
        # what the fused rotation computes: truncated keyed CMuxes over
        # rotated rows, ept = _vm_trunc's; one jitted step (traced and
        # compiled once), the rotation applied outside it
        step = jax.jit(lambda bit, high, rows: jcirc.cmux_keyed(
            par_j, jctx, bit, high[None], rows[None], trunc=ept)[0])
        rows, bits = x["rows"], pr(x["rot_bits"])
        # composed here (N = 64): one full-gadget CMux a bit
        rot = jar.glwe_blind_rotation(par_j, jctx, rows[0], bits, 2, 3, lsh=1,
                                      negate=False)
        sel = jar.select_rd(par_j, jctx, rows[1], bits, SEL_OPS,
                            _jprep_keys(jctx, x["atk"]), SEL_BITS)
        for s, t in enumerate(BROT_AMOUNTS):
            rows = step(bits[:, s: s + 1], jpoly.rotate(rows, t), rows)
        return dict(dp=dp, bw=bw, brot=rows, rot=rot, sel=sel)

    return jax.tree_util.tree_map(np.asarray, _jit(jax_side)(x))




@pytest.mark.parametrize("op", DP_OPS)
@pytest.mark.parametrize("body", BODIES)
def test_dp_group_matches_jax_truncated(truncated, body, op):
    """Kernel 11's route and the composed loop: emit (addi), the subtract
    table (sub) and the MSB flip (slt), the immediate and register groups
    of unequal size."""
    par, _, x, prep, want = truncated
    tctx = _body_ctx(par, body)
    got = tar._dp_group(par, tctx, DP_OPS, prep["rs1"], prep["rs2"], prep["imm"], BITS)
    assert _eq(got[op], want["dp"][op])


@pytest.mark.parametrize("op", BW_OPS)
@pytest.mark.parametrize("body", BODIES)
def test_bitwise_group_matches_jax_truncated(truncated, body, op):
    par, _, x, prep, want = truncated
    tctx = _body_ctx(par, body)
    got = tar._bitwise_group(par, tctx, BW_OPS, prep["rs1"], prep["rs2"], prep["imm"],
                             BITS)
    assert _eq(got[op], want["bw"][op])


def test_truncated_blind_rotation_matches_the_jax_cmux_loop(truncated):
    """Kernel 10 under the VM truncation == truncated keyed CMuxes over
    rotated rows in JAX (a batch of two rows)."""
    par, tctx, x, prep, want = truncated
    got = tar.circuits.blind_rotate_fused(
        par, tctx, _t(x["rows"]), prep["rot_bits"], range(len(BROT_AMOUNTS)),
        BROT_AMOUNTS, trunc=tar._vm_trunc(par, BITS)[0])
    assert _eq(got, want["brot"])


def test_composed_rotation_and_select_rd_match_jax_truncated(truncated):
    """The two-pass route's glwe_blind_rotation (one step, lsh = 1, not
    negated) and select_rd (a rotation by 2 op-id bits and the partial
    trace) == the JAX package's, which run composed at N = 64: the full
    gadget, where the radix-2 route truncates (the test above)."""
    par, _, x, prep, want = truncated
    tctx = _body_ctx(par, "two_pass")
    rot = tar.glwe_blind_rotation(par, tctx, _t(x["rows"][0]), prep["rot_bits"], 2, 3,
                                  lsh=1, negate=False)
    assert _eq(rot, want["rot"])
    sel = tar.select_rd(par, tctx, _t(x["rows"][1]), prep["rot_bits"], SEL_OPS,
                        _tprep_keys(tctx, x["atk"]), SEL_BITS)
    assert _eq(sel, want["sel"])
