"""The PyTorch port stands alone: neither its package nor chip_smoke.py
imports jax or anything of the JAX package."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "fhe_ram_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
IMPORT_JAX = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
IMPORT_REFERENCE = re.compile(r"^\s*(import|from)\s+\.*fhe_ram_tpu(?!_torch)\b", re.M)
# any dotted use of the JAX package as a module (file paths in comments,
# "fhe_ram_tpu/ops/...", name the kernels that were replaced and are fine)
USE_REFERENCE = re.compile(r"(?<![\w/])fhe_ram_tpu\.\w")


def test_port_has_the_expected_layout():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for want in ("params.py", "convert.py", "ops/ntt.py", "ops/ntt_cuda.py",
                 "ops/crt.py", "ops/limb.py", "ops/poly.py", "ops/modular.py",
                 "core/rng.py", "core/glwe.py", "core/ggsw.py",
                 "core/keyswitch.py", "core/packer.py", "core/keys.py",
                 "core/noise.py", "utils/io.py", "utils/profiling.py",
                 "ram/address.py", "ram/ram.py", "tools/time_fold_chunks.py",
                 "vm/fheuint.py", "vm/circuits.py", "vm/arithmetic.py",
                 "vm/store.py", "vm/conversion.py", "vm/cycle.py",
                 "parallel/collective.py", "parallel/mesh.py"):
        assert want in names, want
    assert {p.name for p in (PORT / "csrc").iterdir()} >= {
        "fhe_core.cuh", "ntt.cu", "fold.cu", "external.cu", "trace.cu",
        "pack_merge.cu", "split.cu", "split_tree.cu", "pack_tree.cu",
        "blind_rotate.cu", "dp_chain.cu", "bitwise.cu", "collective.cu"}
    # every source the build names is there, and nothing is left unnamed
    from fhe_ram_tpu_torch.ops import ntt_cuda
    assert {f"{s}.cu" for s in ntt_cuda.SOURCES} == {
        p.name for p in (PORT / "csrc").glob("*.cu")}
    # the kernel built with both transform bodies (kernel 12) counts the
    # two-pass variant apart; the transform (kernel 1) and the fold
    # (kernels 2 and 5) are built once
    both = {"fused_external"}
    assert set(ntt_cuda.BODY_SOURCES) == {"external"}
    assert set(ntt_cuda.LAUNCHES) == both | {f"{k}_two_pass" for k in both} | {
        "ntt_fwd", "ntt_inv", "fused_external_fold", "fused_external_fold_batched",
        "fused_trace", "fused_pack_merge",
        "fused_split", "fused_split_tree", "fused_pack_tree",
        "fused_blind_rotate", "fused_dp_chain", "fused_bitwise",
        "ring_all_gather", "exchange"}
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_source_imports_no_jax(path):
    text = path.read_text()
    assert not IMPORT_JAX.search(text), f"{path} imports jax"
    assert not IMPORT_REFERENCE.search(text), f"{path} imports fhe_ram_tpu"
    assert not USE_REFERENCE.search(text), f"{path} uses fhe_ram_tpu as a module"
    assert "importlib" not in text and "__import__" not in text


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import fhe_ram_tpu_torch, fhe_ram_tpu_torch.convert\n"
        "from fhe_ram_tpu_torch.ops import ntt, ntt_cuda, crt, limb, poly, modular\n"
        "from fhe_ram_tpu_torch.core import rng, glwe, ggsw, keyswitch, packer, keys, noise\n"
        "from fhe_ram_tpu_torch.ram import address, ram\n"
        "from fhe_ram_tpu_torch.utils import io, profiling\n"
        "from fhe_ram_tpu_torch.tools import time_fold_chunks\n"
        "from fhe_ram_tpu_torch.vm import fheuint, circuits, arithmetic, store, conversion, cycle\n"
        "from fhe_ram_tpu_torch.parallel import collective, mesh\n"
        "assert callable(collective.ring_all_gather) and callable(collective.exchange)\n"
        "assert callable(mesh.sharded_read_fn) and callable(mesh.batched_rmw_fn)\n"
        "assert callable(cycle.vm_cycle) and callable(ntt_cuda.fused_dp_chain)\n"
        "assert callable(ram.FheRam.write) and callable(ram.FheRam.read_batch)\n"
        "assert callable(ram.FheRam.rmw_batch) and callable(ram.rmw_batch_impl)\n"
        "assert callable(ntt_cuda.fused_split_tree) and callable(ntt_cuda.fused_pack_tree)\n"
        "assert callable(packer.pack_tree) and callable(packer.pack_prefix)\n"
        "assert callable(ntt_cuda.fused_external) and callable(ntt.fused_path_active)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fhe_ram_tpu' or m.startswith('fhe_ram_tpu.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)
