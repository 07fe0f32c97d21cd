"""Parameter sets and address-digit decomposition helpers.

The scheme's constants are a frozen dataclass; every preset of the
encrypted-RAM system is an instance of it.

Torus representation: a torus element is stored as `limbs` signed base-2^17
digits (int32), limb j having weight 2^-(17*(j+1)).  Gadget decomposition
is free in this layout: the limbs *are* the digits.
"""

from __future__ import annotations

from dataclasses import dataclass

# Three NTT primes, each ~2^19.3-2^19.6, all == 1 (mod 2*4096) so a
# negacyclic NTT of any degree N <= 4096 exists.  Their product
# M ~ 2^58.4 exceeds the worst-case external-product accumulation bound
# (~2^48; see ops/crt.py), so the 3-prime CRT reconstructs exactly.
DEFAULT_PRIMES: tuple[int, ...] = (786433, 737281, 638977)


def reverse_bits_msb(x: int, n: int) -> int:
    """Bit-reverse the low `n` bits of x (reference: src/lib.rs:23-26)."""
    r = 0
    for _ in range(n):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


class Base1D:
    """Vector of digit bit-widths (reference: src/base.rs Base1D)."""

    def __init__(self, bases):
        self.bases = tuple(int(b) for b in bases)

    def size(self) -> int:
        return len(self.bases)

    def max(self) -> int:
        m = 1
        for b in self.bases:
            m <<= b
        return m

    def gap(self, log_n: int) -> int:
        g = log_n
        for b in self.bases:
            g >>= b
        return 1 << g

    def decomp(self, value: int) -> list[int]:
        out, acc = [], 0
        for b in self.bases:
            out.append((value >> acc) & ((1 << b) - 1))
            acc += b
        return out

    def recomp(self, digits) -> int:
        v, acc = 0, 0
        for i, b in enumerate(self.bases):
            v |= digits[i] << acc
            acc += b
        return v

    def __eq__(self, other):
        return isinstance(other, Base1D) and self.bases == other.bases

    def __hash__(self):
        return hash(self.bases)

    def __repr__(self):
        return f"Base1D{self.bases}"


class Base2D:
    """Vector of Base1D (reference: src/base.rs Base2D)."""

    def __init__(self, rows):
        self.rows = tuple(r if isinstance(r, Base1D) else Base1D(r) for r in rows)

    def max_len(self) -> int:
        return max((r.size() for r in self.rows), default=0)

    def as_1d(self) -> Base1D:
        return Base1D([b for r in self.rows for b in r.bases])

    def max(self) -> int:
        return self.as_1d().max()

    def decomp(self, value: int) -> list[int]:
        return self.as_1d().decomp(value)

    def recomp(self, digits) -> int:
        return self.as_1d().recomp(digits)

    def __eq__(self, other):
        return isinstance(other, Base2D) and self.rows == other.rows

    def __repr__(self):
        return f"Base2D{list(self.rows)}"


def get_base_2d(value: int, base) -> Base2D:
    """Greedily pack log2(value) bits into rows of digit widths drawn from
    `base` (reference: src/base.rs:84-108 get_base_2d)."""
    out = []
    bits = max(0, (int(value) - 1).bit_length())
    while bits != 0:
        row = []
        for b in base:
            if b <= bits:
                row.append(b)
                bits -= b
            else:
                if bits != 0:
                    row.append(bits)
                    bits = 0
                break
        out.append(Base1D(row))
    return Base2D(out)


def limbs_for(k: int, base2k: int) -> int:
    return -(-k // base2k)


@dataclass(frozen=True)
class Params:
    """Static FHE-RAM parameters (reference: src/parameters.rs:11-21).

    Defaults are the README/benchmark configuration (README.md:20-33:
    MAX_ADDR=2^18, K_PT=9). Use `PARAMS_CODE_2_14` for the committed-code
    defaults (parameters.rs:14,21: MAX_ADDR=2^14, K_PT=3).
    """

    log_n: int = 12
    base2k: int = 17
    rank: int = 1
    k_pt: int = 9
    k_ct: int = 51            # BASE2K * 3
    k_ggsw: int = 68          # BASE2K * 4 (address GGSW)
    k_evk_trace: int = 68     # BASE2K * 4 (automorphism/trace keys)
    k_evk_ggsw: int = 85      # BASE2K * 5 (GGSW-inversion keys)
    decomp_n: tuple[int, ...] = (3, 3, 3, 3)
    word_size: int = 4
    max_addr: int = 1 << 18
    primes: tuple[int, ...] = DEFAULT_PRIMES
    xs_density: float = 0.5   # secret: sparse ternary, P[nonzero]
    sigma: float = 3.2        # noise std-dev at the finest limb scale

    # READ-path gadget truncation (server-side, keys unchanged).  Read
    # results are ephemeral -- they never persist into the RAM state --
    # so the read pipeline can run its keyswitches/external products on
    # a truncated gadget at a priced noise trade WITHOUT touching the
    # write path's refresh budget (core/noise.py read_noise_log2 prices
    # it; tests/test_noise.py asserts the decode bound).  Truncation is
    # pure slicing: the top limbs of an NTT-prepared key ARE a valid
    # lower-precision key (limb slicing commutes with the per-limb NTT),
    # and the top input limbs ARE the coarse gadget digits.
    #   read_ks_digits: input digits decomposed in pack/trace
    #     keyswitches (None = limbs_ct).
    #   read_ks_limbs: evaluation-key limbs consumed there
    #     (None = limbs_evk_trace).
    #   read_ep_digits / read_ep_limbs: same for the read's coordinate
    #     external products (digits: ct limbs; limbs: address-GGSW
    #     limbs).  read_ep_digits requires single-digit coordinates
    #     (wide decomp_n) -- chained CMux digits re-decompose in-kernel.
    read_ks_digits: int | None = None
    read_ks_limbs: int | None = None
    read_ep_digits: int | None = None
    read_ep_limbs: int | None = None

    # RPW-path gadget truncation (round 4).  With the exact-data-carry
    # write (ram/ram.py), the rpw tree's noise reaches the RAM ONLY
    # through the write delta (w - trace(root)) -- the carried rows
    # never pass an external product -- so the rpw's products/packs and
    # the write's root trace can also run on a truncated gadget at a
    # priced trade against the per-cycle delta noise
    # (core/noise.write_cycle_added_var prices it; the refresh budget
    # must stay above the reference's ~40M bar).  Same slicing
    # semantics as the read_* fields.
    rpw_ks_digits: int | None = None
    rpw_ks_limbs: int | None = None
    rpw_ep_digits: int | None = None
    rpw_ep_limbs: int | None = None

    def __post_init__(self):
        assert sum(self.decomp_n) == self.log_n, "decomp_n must sum to log_n"
        assert self.base2k == 17, "only base2k=17 is wired up"
        for p in self.primes:
            assert (p - 1) % (2 << self.log_n) == 0, "prime lacks 2N-th root"
        if self.read_ks_digits is not None:
            assert 1 <= self.read_ks_digits <= self.limbs_ct
        if self.read_ks_limbs is not None:
            assert 1 <= self.read_ks_limbs <= self.limbs_evk_trace
        if self.read_ep_digits is not None:
            assert 1 <= self.read_ep_digits <= self.limbs_ct
            assert max(len(r.bases) for r in self.base2d().rows) == 1, (
                "read_ep_digits needs single-digit (wide) coordinates")
        if self.read_ep_limbs is not None:
            assert 1 <= self.read_ep_limbs <= self.limbs_ggsw
        if self.rpw_ks_digits is not None:
            assert 1 <= self.rpw_ks_digits <= self.limbs_ct
        if self.rpw_ks_limbs is not None:
            assert 1 <= self.rpw_ks_limbs <= self.limbs_evk_trace
        if self.rpw_ep_digits is not None:
            assert 1 <= self.rpw_ep_digits <= self.limbs_ct
            assert max(len(r.bases) for r in self.base2d().rows) == 1, (
                "rpw_ep_digits needs single-digit (wide) coordinates")
        if self.rpw_ep_limbs is not None:
            assert 1 <= self.rpw_ep_limbs <= self.limbs_ggsw

    @property
    def read_ks_trunc(self) -> tuple[int | None, int | None]:
        return (self.read_ks_digits, self.read_ks_limbs)

    @property
    def read_ep_trunc(self) -> tuple[int | None, int | None]:
        return (self.read_ep_digits, self.read_ep_limbs)

    @property
    def rpw_ks_trunc(self) -> tuple[int | None, int | None]:
        return (self.rpw_ks_digits, self.rpw_ks_limbs)

    @property
    def rpw_ep_trunc(self) -> tuple[int | None, int | None]:
        return (self.rpw_ep_digits, self.rpw_ep_limbs)

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def num_primes(self) -> int:
        return len(self.primes)

    # --- limb counts ------------------------------------------------------
    @property
    def limbs_ct(self) -> int:
        return limbs_for(self.k_ct, self.base2k)

    @property
    def limbs_ggsw(self) -> int:
        return limbs_for(self.k_ggsw, self.base2k)

    @property
    def limbs_evk_trace(self) -> int:
        return limbs_for(self.k_evk_trace, self.base2k)

    @property
    def limbs_evk_ggsw(self) -> int:
        return limbs_for(self.k_evk_ggsw, self.base2k)

    # --- gadget digit counts (reference: parameters.rs:273-279) ----------
    @property
    def dnum_ct(self) -> int:
        return limbs_for(self.k_ct, self.base2k)

    @property
    def dnum_ggsw(self) -> int:
        return limbs_for(self.k_ggsw, self.base2k)

    # --- address geometry -------------------------------------------------
    def base2d(self) -> Base2D:
        return get_base_2d(self.max_addr, self.decomp_n)

    @property
    def n2(self) -> int:
        return len(self.base2d().rows)

    @property
    def num_rows(self) -> int:
        """Number of GLWE rows holding the RAM (ceil(max_addr / N))."""
        return -(-self.max_addr // self.n)

    def tree_shape(self) -> list[int]:
        """Row counts of the persistent packing tree levels
        (reference: src/ram.rs:306-332)."""
        out = []
        if self.max_addr > self.n:
            size = -(-self.max_addr // self.n)
            while size != 1:
                size = -(-size // self.n)
                out.append(size)
        return out

    @property
    def trace_gal_els(self) -> tuple[int, ...]:
        """Galois elements g_k = N/2^k + 1 used by trace and packing.

        Step k of the normalized trace maps X -> X^{g_k}; the same set
        drives the packing tree merges (core/packer.py)."""
        return tuple((self.n >> k) + 1 for k in range(self.log_n))


# README / benchmark configuration (README.md:29-36): 2^18 addresses,
# 4xu8 words, K_PT = 9.
PARAMS_README_2_18 = Params()

# Committed-code defaults (parameters.rs:14,21): 2^14 addresses, K_PT = 3.
PARAMS_CODE_2_14 = Params(k_pt=3, max_addr=1 << 14)

# Scaled RAM (BASELINE.json config 4): 2^24 addresses (64 MB of 4xu8
# words), deeper packing tree, rows shardable over a mesh.
PARAMS_2_24 = Params(max_addr=1 << 24)

# Wide-digit address decomposition: ONE GGSW per coordinate
# (decomp_n=(12,) -> base2d [[12],[6]] at 2^18 instead of
# [[3,3,3,3],[3,3]]).  decomp_n is a first-class constructor parameter
# of the reference too (Ram::new_from_ram_params, src/ram.rs:72-87) --
# this is a configuration of the same scheme, not a scheme change:
#   * the CMux chain per coordinate is 1 external product instead of 4
#     (the monomial message has operator norm 1 at any exponent width,
#     so the EP key-noise term is added ONCE instead of once per digit
#     -- strictly LESS noise, see core/noise.py),
#   * the encrypted address is 4x smaller (1 GGSW per coordinate),
#   * FheUint->Address conversion cost is unchanged (the blind rotation
#     walks the same total bit count either way, vm/conversion.py).
# The upstream project's tiny default digits buy nothing on an
# accelerator; the wide presets are the ones a deployment runs.
PARAMS_2_18_WIDE = Params(decomp_n=(12,))
PARAMS_2_14_WIDE = Params(k_pt=3, max_addr=1 << 14, decomp_n=(12,))
PARAMS_2_24_WIDE = Params(max_addr=1 << 24, decomp_n=(12,))

# Turbo: wide digits + address GGSWs at k_ggsw=51 (3 limbs instead of
# 4).  Each external product drops from 8 to 6 inverse transforms and
# the VMP shrinks 25%.  Analytic read bound -23.7 (decode needs < -10)
# and refresh budget 4.9e7 RMW cycles -- still above the reference's
# published >= ~40M (README.md:36); see tests/test_noise.py.
PARAMS_2_18_TURBO = Params(decomp_n=(12,), k_ggsw=51)

# Read-optimized: wide digits + READ-path gadget truncation (see the
# Params docstring fields).  Every read keyswitch decomposes 2 of 3
# input digits against 3 of 4 evaluation-key limbs, and every read
# coordinate product consumes 2 of 3 ct digits against 3 of 4 address-
# GGSW limbs -- ~35% less inverse-transform/VMP work on the read's
# critical path.  Pure server-side slicing: keys, address, and the
# WRITE path (and hence the refresh budget) are identical to
# PARAMS_2_18_WIDE.  Analytic read bound: core/noise.py prices the
# truncation (tests/test_noise.py asserts it under the decode bound).
PARAMS_2_18_READOPT = Params(
    decomp_n=(12,),
    read_ks_digits=2, read_ks_limbs=3,
    read_ep_digits=2, read_ep_limbs=3,
)
PARAMS_2_24_READOPT = Params(
    max_addr=1 << 24, decomp_n=(12,),
    read_ks_digits=2, read_ks_limbs=3,
    read_ep_digits=2, read_ep_limbs=3,
)

# 2^14 read-optimized: the code-default config takes the same ks
# truncation and a DEEPER ep truncation (1 of 3 ct digits): at k_pt=3
# the decode bound is -4, so the analytic read bound -10.2 keeps a
# 6-bit margin (tests/test_noise.py).
PARAMS_2_14_READOPT = Params(
    k_pt=3, max_addr=1 << 14, decomp_n=(12,),
    read_ks_digits=2, read_ks_limbs=3,
    read_ep_digits=1, read_ep_limbs=3,
)

# Turbo x read-optimized cross: k_ggsw=51 address GGSWs (3 limbs) PLUS
# the read-path truncation.  The read path is identical to READOPT
# (read_ep_limbs=3 already consumes only 3 GGSW limbs); the gain is on
# the WRITE path, whose inverse-coordinate products consume the full
# GGSW -- 25% less VMP and 2 fewer inverse transforms per EP there.
# Analytic read bound -16.3 (same as READOPT -- trace noise dominates);
# refresh budget 4.9e7 RMW cycles, still above the reference's >= ~40M.
PARAMS_2_18_TURBO_READOPT = Params(
    decomp_n=(12,), k_ggsw=51,
    read_ks_digits=2, read_ks_limbs=3,
    read_ep_digits=2, read_ep_limbs=3,
)

# Small parameters for fast CPU tests (same limb structure, tiny ring).
PARAMS_TEST_SMALL = Params(
    log_n=6,
    k_pt=3,
    decomp_n=(3, 3),
    word_size=2,
    max_addr=1 << 8,
)

# Wide-digit test config (single-GGSW coordinates, see PARAMS_2_18_WIDE).
PARAMS_TEST_SMALL_WIDE = Params(
    log_n=6,
    k_pt=3,
    decomp_n=(6,),
    word_size=2,
    max_addr=1 << 8,
)

# Rank-2 test config: exercises the generic-rank paths (GLWE with two
# mask components, rank-2 GGSW, per-component tensor keys).
PARAMS_TEST_RANK2 = Params(
    log_n=6,
    rank=2,
    k_pt=3,
    decomp_n=(3, 3),
    word_size=2,
    max_addr=1 << 8,
)

# VM test config: ring large enough for u32 words (gap = N/32 = 16 >= the
# 16 store-select cases; the reference's store test also uses N=512,
# src/store.rs:163).
PARAMS_TEST_VM = Params(
    log_n=9,
    k_pt=3,
    decomp_n=(3, 3, 3),
    word_size=2,
    max_addr=1 << 9,
)

# Full-enum VM test config: N=1024 so the 20 RV32I op slots fit the u32
# stride (gap = N/32 = 32 >= 20; the reference's arithmetic test also
# runs at N=1024, src/arithmetic.rs:254).
PARAMS_TEST_VM1024 = Params(
    log_n=10,
    k_pt=3,
    decomp_n=(3, 3, 4),
    word_size=2,
    max_addr=1 << 10,
)

# Single-level test config (max_addr <= N, n2 == 1).
PARAMS_TEST_FLAT = Params(
    log_n=6,
    k_pt=3,
    decomp_n=(3, 3),
    word_size=2,
    max_addr=1 << 5,
)

# 3-level test config (max_addr > N^2: base2d has three rows, 128 base
# rows -> multi-chunk level-0 packs -> tree levels [2, 1]).  Exercises
# the generic mid-level loops of write_impl / rmw_batch_impl
# (reference: the ram.rs:461-649 walk at arbitrary depth).
PARAMS_TEST_3LVL = Params(
    log_n=6,
    k_pt=3,
    decomp_n=(3, 3),
    word_size=2,
    max_addr=1 << 13,
)
