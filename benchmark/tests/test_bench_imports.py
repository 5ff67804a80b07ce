"""No module that a benchmark run loads has the top-level name jax,
jaxlib, flax or gfalign_tpu (compared as whole top-level names: the
port's name begins with the JAX package's), and the references and the
generator load nothing of the program."""

import ast
import pathlib
import subprocess
import sys

from benchmark import common

HERE = pathlib.Path(__file__).resolve().parents[1]


def test_a_run_loads_no_jax():
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from benchmark.tests.small import run_small\n"
        "run_small('hifi.search_tangle', seconds=0.2, trace=1)\n"
        "run_small('hifi.align', seconds=0.2, trace=1)\n"
        "from benchmark import common\n"
        "print(json.dumps(common.forbidden_loaded()))\n") % str(common.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=common.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_name_no_jax():
    for path in HERE.rglob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & set(common.FORBIDDEN), path


def test_reference_and_generator_import_nothing_of_the_program():
    for path in [HERE / "workload.py", *(HERE / "reference").glob("*.py")]:
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert tops <= {"__future__", "heapq", "random", "re", "typing",
                        "dataclasses", "numpy"}, (path, tops)


def test_forbidden_is_whole_names():
    sys.modules.setdefault("gfalign_tpux_probe", sys)
    try:
        assert "gfalign_tpux_probe" not in common.forbidden_loaded()
    finally:
        del sys.modules["gfalign_tpux_probe"]
