"""The port stands alone: no module of gfalign_torch, and not
chip_smoke.py, imports jax or anything of gfalign_tpu or reads one of the
JAX package's environment variables, and the CLI imports with jax made
unimportable."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "gfalign_torch").rglob("*.py")) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "gfalign_tpu")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_neither_jax_nor_the_jax_package(source):
    tree = ast.parse((ROOT / source).read_text(), filename=source)
    bad = sorted(set(_imported_roots(tree)) & set(FORBIDDEN))
    assert not bad, f"{source} imports {bad}"


@pytest.mark.parametrize("source", SOURCES)
def test_source_reads_no_variable_of_the_jax_package(source):
    """The port's environment variables are GFALIGN_TORCH_*; a string that
    names a GFALIGN_TPU_* variable would be a read of the JAX package's."""
    tree = ast.parse((ROOT / source).read_text(), filename=source)
    bad = sorted({node.value for node in ast.walk(tree)
                  if isinstance(node, ast.Constant) and isinstance(node.value, str)
                  and node.value.startswith("GFALIGN_TPU_")})
    assert not bad, f"{source} names {bad}"


def test_align_modules_are_scanned():
    for name in ("gfalign_torch/io/fastq.py", "gfalign_torch/ops/seqalign.py",
                 "gfalign_torch/ops/seqalign_cuda.py", "gfalign_torch/ops/cuda_build.py",
                 "gfalign_torch/engine/seeding.py", "gfalign_torch/engine/graph_align.py",
                 "gfalign_torch/engine/aligner.py", "gfalign_torch/io/native.py",
                 "gfalign_torch/io/cache.py", "chip_smoke.py"):
        assert name in SOURCES, name


def test_every_module_imports_with_jax_blocked():
    modules = [s[:-3].replace("/", ".").removesuffix(".__init__")
               for s in SOURCES if s.startswith("gfalign_torch/")]
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'gfalign_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "import gfalign_torch.cli.main\n"
            "assert not any(k.split('.')[0] in ('jax', 'gfalign_tpu')\n"
            "               and sys.modules[k] is not None for k in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
