"""The port's golden-output validator (gfalign_torch/cli/validate.py) and
test generator (gfalign_torch/cli/generate_tests.py) on the CPU: .tst
files written here in both forms (embedded and expected-output file) with
passing and failing cases and every exit code, and the .tst files of the
JAX package's tools/generate_tests.py and of the port's generator, byte-
equal on synth fixtures laid out as the reference's testFiles/random{1,2,3}.*
and passed by the port's validator."""

import contextlib
import importlib.util
import io
import pathlib

import pytest

from gfalign_tpu.cli.main import main as jax_main
from gfalign_torch import synth
from gfalign_torch.cli import generate_tests, validate
from gfalign_torch.io.writers import write_gfa1

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setenv("GFALIGN_TORCH_DEVICE", "cpu")


def write_fixture(wl, d, name):
    with open(d / f"{name}.gfa", "w") as fh:
        write_gfa1(wl.graph, fh.write)
    synth.write_truth_gaf(wl, str(d / f"{name}.gaf"))
    (d / f"{name}.search_nodelist.tsv").write_text(
        "".join(row + "\n" for row in wl.search_nodelist))
    (d / f"{name}.filter_nodelist.ls").write_text(
        "".join(n + "\n" for n in wl.filter_nodelist))


@pytest.fixture(scope="module")
def test_files(tmp_path_factory):
    """testFiles/random{1,2,3}.*: two small graphs with bubbles for
    evalGFA, and a 6-segment graph with a K4 tangle over segments 2-5 for
    search (-s 1 -d 4) and filter."""
    d = tmp_path_factory.mktemp("fixtures") / "testFiles"
    d.mkdir()
    small = dict(seg_len=(60, 150), read_len=(150, 500), bubble_every=3)
    write_fixture(synth.make_workload(seed=1, n_segments=12, n_reads=15, tangle_k=2,
                                      **small), d, "random1")
    write_fixture(synth.make_workload(seed=2, n_segments=16, n_reads=25, tangle_k=3,
                                      **small), d, "random2")
    write_fixture(synth.make_workload(seed=3, n_segments=6, n_reads=20, tangle_k=4,
                                      **small), d, "random3")
    # the generator's search runs -s 1 -d 4 into the tangle over 2-5
    (d / "random3.search_nodelist.tsv").write_text("1\t1\n2\t2\n3\t2\n4\t1\n")
    return d


def jax_stdout(argv, cwd):
    buf = io.StringIO()
    with contextlib.chdir(cwd), contextlib.redirect_stdout(buf):
        assert jax_main(argv) == 0
    return buf.getvalue()


def run_validate(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = validate.main([str(a) for a in argv])
    return code, buf.getvalue()


def make_root(tmp_path, test_files):
    root = tmp_path / "root"
    (root / "validateFiles").mkdir(parents=True)
    (root / "testFiles").symlink_to(test_files)
    return root


def test_validator_passes_fails_and_exits_as_the_reference(tmp_path, test_files):
    root = make_root(tmp_path, test_files)
    vf = root / "validateFiles"
    cmd = "gfalign evalGFA -f testFiles/random1.gfa -g testFiles/random1.gaf"
    want = jax_stdout(cmd.split()[1:], root)
    assert want.count("\n") > 3
    (vf / "embedded.tst").write_text(f"{cmd}\nembedded\n{want}")
    (vf / "expected.out").write_text(want)
    (vf / "file.tst").write_text(f"{cmd}\nexpected.out\n")
    code, out = run_validate([vf])
    assert code == 0, out
    assert out.count("PASS") == 2 and out.rstrip().endswith("2/2 passed")

    lines = want.split("\n")
    lines[2] = lines[2] + "x"
    (vf / "wrong.tst").write_text(f"{cmd}\nembedded\n" + "\n".join(lines))
    code, out = run_validate([vf])
    assert code == 1
    assert "FAIL" in out and "2/3 passed" in out
    assert f"  line 3: got      {want.split(chr(10))[2]!r}" in out
    assert f"  line 3: expected {lines[2]!r}" in out

    crash = tmp_path / "other" / "validateFiles"
    crash.mkdir(parents=True)
    (crash / "bad.tst").write_text("gfalign nosuchmode -f x\nembedded\n")
    code, out = run_validate([crash / "bad.tst", vf / "embedded.tst"])
    assert code == 1 and "1/2 passed" in out and "line" not in out

    assert run_validate([])[0] == 2
    assert run_validate([tmp_path / "missing"])[0] == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert run_validate([empty])[0] == 2


def test_validator_leaves_no_scratch_directory(tmp_path, test_files, monkeypatch):
    """Each .tst runs in a scratch directory of symlinks that is removed
    after it, passed, failed or crashed."""
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr("tempfile.tempdir", str(scratch))
    root = make_root(tmp_path, test_files)
    vf = root / "validateFiles"
    cmd = "gfalign evalGFA -f testFiles/random1.gfa -g testFiles/random1.gaf"
    want = jax_stdout(cmd.split()[1:], root)
    (vf / "pass.tst").write_text(f"{cmd}\nembedded\n{want}")
    (vf / "fail.tst").write_text(f"{cmd}\nembedded\n{want}x")
    (vf / "crash.tst").write_text("gfalign nosuchmode -f x\nembedded\n")
    code, out = run_validate([vf])
    assert code == 1 and "1/3 passed" in out
    assert list(scratch.iterdir()) == []


def test_validator_without_a_card_exits_2(tmp_path, test_files, monkeypatch):
    """CUDA is the default device: without a card and without
    GFALIGN_TORCH_DEVICE=cpu the validator says so and runs nothing."""
    monkeypatch.delenv("GFALIGN_TORCH_DEVICE")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    root = make_root(tmp_path, test_files)
    (root / "validateFiles" / "t.tst").write_text("gfalign evalGFA -g testFiles/random1.gaf"
                                                  "\nembedded\n")
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        code, out = run_validate([root / "validateFiles"])
    assert code == 2 and "no CUDA device" in buf.getvalue() and "PASS" not in out


def load_jax_generator():
    spec = importlib.util.spec_from_file_location("jax_generate_tests",
                                                  ROOT / "tools" / "generate_tests.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_generators_write_the_same_tst_and_the_validator_passes_them(tmp_path, test_files):
    jax_gen = load_jax_generator()
    assert jax_gen.MATRIX == generate_tests.MATRIX
    jax_dir = tmp_path / "jax" / "validateFiles"
    port_dir = tmp_path / "port" / "validateFiles"
    with contextlib.redirect_stdout(io.StringIO()):
        jax_written = jax_gen.generate(str(test_files), str(jax_dir))
        port_written = generate_tests.generate(str(test_files), str(port_dir))
    assert [p.name for p in jax_written] == [p.name for p in port_written]
    assert len(port_written) == len(generate_tests.MATRIX)
    for a, b in zip(jax_written, port_written):
        assert a.read_bytes() == b.read_bytes(), a.name
    search = (port_dir / "test.6.tst").read_text().split("\n")
    assert len(search) > 3, search          # the search prints rows
    for d in (jax_dir, port_dir):
        code, out = run_validate([d])
        assert code == 0, out
        assert out.rstrip().endswith(f"{len(port_written)}/{len(port_written)} passed")


def test_generator_prompt(tmp_path, test_files, monkeypatch):
    """Without -y the generator asks first, and anything but y cancels
    (nothing is written); two arguments are required."""
    monkeypatch.setattr("builtins.input", lambda prompt: "n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert generate_tests.main([str(test_files), str(tmp_path / "v")]) == 0
        assert generate_tests.main([str(test_files)]) == 2
    assert "validate generation cancelled" in buf.getvalue()
    assert not (tmp_path / "v").exists()
    with contextlib.redirect_stdout(io.StringIO()):
        assert generate_tests.main([str(test_files), str(tmp_path / "v"), "-y"]) == 0
    assert len(list((tmp_path / "v").glob("*.tst"))) == len(generate_tests.MATRIX)
