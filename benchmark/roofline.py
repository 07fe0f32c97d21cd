"""The least time one H100 could take for a server call's kernels.

Peaks of one H100 SXM at its full 700 W limit (NVIDIA's data sheet): device
memory 3.35 TB/s, and 67 T/s of 32-bit arithmetic outside the tensor cores.
The kernels do 32-bit integer modular work on those units, which are no
faster for integers than the float32 rate, so a bound taken from it is a
floor and a share of it can only read low.

Operations are counted in the ring Z_p: one modular multiply, add or
subtract is one operation.  An n-point transform is (n/2) log2 n
butterflies of 3 operations plus n twist multiplies; a fold's product is
one multiply and one add per (digit poly, output poly, coefficient); the
Garner step, the digit split and the carry are ~40 operations a
reconstructed coefficient.  Bytes count each input polynomial read once and
each output polynomial written once (4 bytes a coefficient).

The work of a call is reckoned from the configuration's shapes alone (rows,
digits, gadget, primes), never from a kernel's launch arguments, so it is
the same whatever kernel carries each step.  `call_launches` lists it as
(layer, bytes, operations) a step, in the order the server runs them.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
PRIMES = 3  # the CRT basis the configurations name


def ntt_ops(n: int) -> int:
    return 3 * (n // 2) * int(math.log2(n)) + n


def fold_ops(rows: int, T: int, M: int, n: int, P: int = PRIMES,
             spectral: bool = False) -> int:
    """One fold over `rows` rows of T digit polys against M output polys.
    spectral: the digits come transformed, no forward transforms."""
    fwd = 0 if spectral else T * ntt_ops(n)
    return rows * (P * (fwd + M * (2 * T * n + ntt_ops(n))) + 40 * M * n)


def least_seconds(bytes_moved: float, ops: float) -> float:
    """The larger of the memory bound and the arithmetic bound."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)


class Shapes:
    """The sizes a configuration's parameters (its JSON `params`) fix."""

    def __init__(self, p: dict):
        b = int(p.get("base2k", 17))
        self.n = 1 << int(p["log_n"])
        self.log_n = int(p["log_n"])
        self.rank = int(p.get("rank", 1))
        self.C = self.rank + 1
        self.L = -(-int(p["k_ct"]) // b)
        self.Lg = -(-int(p["k_ggsw"]) // b)
        self.Lkt = -(-int(p["k_evk_trace"]) // b)
        self.Lkg = -(-int(p["k_evk_ggsw"]) // b)
        self.D = self.L                        # an address GGSW's digit rows
        self.W = int(p["word_size"])
        self.P = len(p.get("primes", (0,) * PRIMES))
        max_addr = int(p["max_addr"])
        self.R = -(-max_addr // self.n)
        self.levels = (self.R - 1).bit_length()
        self.digits = self._digits(max_addr, [int(d) for d in p["decomp_n"]])
        self.poly = 4 * self.n

    @staticmethod
    def _digits(max_addr: int, decomp):
        """Digits a coordinate: the address bits packed greedily into rows
        of the decomposition's widths (one GGSW a digit)."""
        bits, rows = max(0, (max_addr - 1).bit_length()), []
        while bits:
            row = 0
            for w in decomp:
                if w <= bits:
                    row, bits = row + 1, bits - w
                else:
                    row, bits = row + (1 if bits else 0), 0
                    break
            rows.append(row)
        return rows


def _fold(s: Shapes, rows, dig, T, M, out_l, keys_a=1, in_rows=None,
          spectral_first=False):
    """A chain of `dig` folds over `rows` rows against keys_a key sets (one
    an address in a batched fold).  spectral_first: digit 0 reads the
    shared spectra of in_rows rows (the same for every address) and skips
    its forward transforms."""
    ops = dig * fold_ops(rows, T, M, s.n, s.P)
    if spectral_first:
        ops -= rows * s.P * T * ntt_ops(s.n)  # digit 0's forward transforms
        n_in = s.P * in_rows * T
    else:
        n_in = rows * T
    polys = n_in + keys_a * s.P * dig * T * M + rows * s.C * out_l
    return ("fold", s.poly * polys, ops)


def _merge(s: Shapes, nb):
    T, M = s.rank * s.L, s.C * s.Lkt
    return ("keyswitch", s.poly * (3 * nb * s.C * s.L + s.P * T * M),
            fold_ops(nb, T, M, s.n, s.P))


def _trace(s: Shapes, rows):
    T, M = s.rank * s.L, s.C * s.Lkt
    return ("keyswitch", s.poly * (2 * rows * s.C * s.L + s.log_n * s.P * T * M),
            s.log_n * fold_ops(rows, T, M, s.n, s.P))


def _split(s: Shapes, nb):
    T, M = s.rank * s.L, s.C * s.Lkt
    return ("keyswitch", s.poly * (3 * nb * s.C * s.L + s.P * T * M),
            fold_ops(nb, T, M, s.n, s.P) + 4 * nb * s.C * s.L * s.n)


def _pack(s: Shapes, rows_per_subram, A=1):
    """The pack of each subram's rows into one: a merge a level, the rows
    halving from a power of two."""
    m = 1 << (rows_per_subram - 1).bit_length() if rows_per_subram > 1 else 1
    out = []
    while m > 1:
        m //= 2
        out.append(_merge(s, A * s.W * m))
    return out


def _inversion(s: Shapes, dig, B=None):
    """GGSW(X^e) -> GGSW(X^-e) of `dig` digit GGSWs: the b-rows keyswitched
    under the GGSW-level key, then the tensor-key product of each of `rank`
    a-rows, then the transform of the result.  A single write inverts one
    digit GGSW a step; a batch of B addresses every GGSW of the coordinate
    in one step."""
    out = []
    T_ks, T_tk, M = s.rank * s.Lg, s.C * s.Lg, s.C * s.Lkg
    steps, rows = (dig, s.D) if B is None else (1, B * dig * s.D)
    for _ in range(steps):
        out.append(("fold", s.poly * (rows * T_ks + s.P * T_ks * M + 2 * rows * s.C * s.Lg),
                    fold_ops(rows, T_ks, M, s.n, s.P)))
        for _ in range(s.rank):
            out.append(("fold", s.poly * (rows * T_tk + s.P * T_tk * M + rows * s.C * s.Lg),
                        fold_ops(rows, T_tk, M, s.n, s.P)))
    polys = dig * (B or 1) * s.D * s.C * s.C * s.Lg
    out.append(("ntt", polys * s.poly * (1 + s.P), polys * s.P * ntt_ops(s.n)))
    return out


def _read_path(s: Shapes, A=None):
    """Level 0's chained fold over every row, the pack, then each higher
    level's fold over W rows (A addresses: batched, digit 0 of level 0 on
    the shared spectra of the RAM's digit rows)."""
    T, M = s.C * s.L, s.C * s.Lg
    out = []
    if A is None:
        rows = s.W * s.R
        out.append(_fold(s, rows, s.digits[0], T, M, s.L))
    else:
        polys = s.W * s.R * T
        out.append(("ntt", polys * s.poly * (1 + s.P), polys * s.P * ntt_ops(s.n)))
        out.append(_fold(s, A * s.W * s.R, s.digits[0], T, M, s.L, keys_a=A,
                         in_rows=s.W * s.R, spectral_first=True))
    for dig in s.digits[1:]:
        out.extend(_pack(s, s.R, A or 1))
        out.append(_fold(s, (A or 1) * s.W, dig, T, M, s.L, keys_a=A or 1))
    out.append(_trace(s, (A or 1) * s.W))
    return out


def _write(s: Shapes, B=None):
    """The write: the root's trace, then for the top level the delta's
    inverse product and the slot extraction's split levels, then the
    inversion of level 0 and the update over every row (B addresses: each
    step over all of them, with a key set an address)."""
    T, M = s.C * s.L, s.C * s.Lg
    A = B or 1
    out = [] if B else [_trace(s, s.W)]
    out.extend(_inversion(s, s.digits[1], B))
    out.append(_fold(s, A * s.W, s.digits[1], T, M, s.L, keys_a=A))
    nb = A * s.W
    for _ in range(s.levels):
        out.append(_split(s, nb))
        nb *= 2
    out.extend(_inversion(s, s.digits[0], B))
    out.append(_fold(s, A * s.W * s.R, s.digits[0], T, M, s.L, keys_a=A))
    return out


def call_launches(params: dict, op: str, batch: int = 1):
    """(layer, bytes, operations) of every kernel step of one server call:
    op "read" (FheRam.read), "rmw" (read_prepare_write then write),
    "read_batch" (FheRam.read_batch of `batch` addresses) or "rmw_batch"
    (FheRam.rmw_batch of `batch` addresses: the batched read's steps, its
    trace on the full gadget, then the batched write's)."""
    s = Shapes(params)
    if len(s.digits) != 2:
        raise ValueError("the work is reckoned for two address levels")
    if op == "read":
        return _read_path(s)
    if op == "rmw":
        return _read_path(s) + _write(s)
    if op == "read_batch":
        return _read_path(s, A=batch)
    if op == "rmw_batch":
        return _read_path(s, A=batch) + _write(s, B=batch)
    raise ValueError(f"no work is reckoned for op {op!r}")


def layer_least_seconds(params: dict, op: str, layer: str, batch: int = 1) -> float:
    """The least time of one call's steps of `layer`, step by step."""
    return sum(least_seconds(b, o) for lay, b, o in call_launches(params, op, batch)
               if lay == layer)
