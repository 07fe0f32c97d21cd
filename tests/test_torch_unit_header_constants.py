"""The limits and argument structs of ops/ntt_cuda.py against the CUDA
sources they mirror (csrc/): a mismatch would corrupt every
launch's arguments, and the CPU tests never build the kernels.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import ctypes
import re
from pathlib import Path

from fhe_ram_tpu_torch.ops import ntt_cuda

CSRC = Path(ntt_cuda.__file__).resolve().parent.parent / "csrc"


def test_python_limits_and_structs_match_the_cuda_header():
    text = "\n".join(p.read_text() for p in sorted(CSRC.iterdir()))
    defines = {k: int(v) for k, v in re.findall(r"#define (FHE_\w+) (\d+)", text)}
    assert defines["FHE_MAX_L"] == ntt_cuda._MAX_L
    assert defines["FHE_MAX_STEPS"] == ntt_cuda._MAX_STEPS
    assert defines["FHE_MAX_OPS"] == ntt_cuda._MAX_OPS
    assert defines["FHE_MAX_LEAVES"] == 8 * ntt_cuda._MAX_OPS
    assert defines["FHE_P"] == 3 and defines["FHE_THREADS"] == 512
    assert int(re.search(r"#define FOLD_MAX_LK (\d+)", text).group(1)) == ntt_cuda._FOLD_MAX_LK

    def fields(struct):
        body = re.search(r"struct %s \{(.*?)\n\};" % struct, text, re.S).group(1)
        return re.findall(r"(\w+)(?:\[\w+\])?;", body)   # the declared names

    for struct, mirror in (("FoldShape", ntt_cuda._FoldShape),
                           ("TraceSteps", ntt_cuda._TraceSteps),
                           ("TreeLevels", ntt_cuda._TreeLevels),
                           ("SplitLevels", ntt_cuda._SplitLevels),
                           ("FheConsts", ntt_cuda._Consts),
                           ("FheTables", ntt_cuda._Tables),
                           ("RotSteps", ntt_cuda._RotSteps),
                           ("DpTables", ntt_cuda._DpTables),
                           ("OpGroups", ntt_cuda._OpGroups),
                           ("FoldTables", ntt_cuda._FoldTables)):
        assert fields(struct) == [name for name, _ in mirror._fields_], struct
    steps = ntt_cuda._MAX_STEPS
    assert ctypes.sizeof(ntt_cuda._TraceSteps) == 4 * (1 + steps)
    assert ctypes.sizeof(ntt_cuda._TreeLevels) == 4 * (1 + 3 * steps)
    assert ctypes.sizeof(ntt_cuda._SplitLevels) == 4 * (1 + 2 * steps)
    assert ctypes.sizeof(ntt_cuda._FoldShape) == 4 * 8
    assert ctypes.sizeof(ntt_cuda._RotSteps) == 4 * (1 + steps)
    ops = ntt_cuda._MAX_OPS
    assert ctypes.sizeof(ntt_cuda._OpGroups) == 4 * (1 + ops)
    assert ctypes.sizeof(ntt_cuda._DpTables) == 4 * (1 + ops) + 8 * ops
