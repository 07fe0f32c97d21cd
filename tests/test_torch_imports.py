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
                 "ram/address.py", "ram/ram.py"):
        assert want in names, want
    assert {p.name for p in (PORT / "csrc").iterdir()} >= {
        "fhe_core.cuh", "ntt.cu", "fold.cu", "trace.cu", "pack_merge.cu"}
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
        "from fhe_ram_tpu_torch.core import rng, glwe, ggsw, keyswitch, packer, keys\n"
        "from fhe_ram_tpu_torch.ram import address, ram\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fhe_ram_tpu' or m.startswith('fhe_ram_tpu.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)
