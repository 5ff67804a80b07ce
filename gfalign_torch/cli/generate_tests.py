"""Regenerate golden `.tst` files with the port (the counterpart of the
JAX package's tools/generate_tests.py; reference gfalign-generate-tests,
src/generate-tests.cpp:7-90 + include/validate.h:77-95).

Each test.N.tst = line 1 command (relative to the validate dir's parent),
line 2 the literal `embedded`, remaining lines the command's stdout:
exactly the format cli/validate.py and the reference's gfalign-validate
consume.  The covered matrix mirrors the reference generator: evalGFA on
random1/random2 x {plain, --graph-statistics, --sort-alignment}, search on
random3, filter on random3 (src/generate-tests.cpp:37-81).  Commands score
on CUDA unless GFALIGN_TORCH_DEVICE=cpu is set.

Usage:
    python -m gfalign_torch.cli.generate_tests <testFiles-dir> <output-dir> [-y]

WARNING (like the reference): existing *.tst in <output-dir> are deleted;
only run when the framework is in a known-good state.  -y skips the
confirmation prompt.
"""

from __future__ import annotations

import io
import os
import pathlib
import sys

MATRIX = [
    ("evalGFA", "-f testFiles/random1.gfa", "-g testFiles/random1.gaf"),
    ("evalGFA", "-f testFiles/random1.gfa",
     "-g testFiles/random1.gaf --graph-statistics"),
    ("evalGFA", "-f testFiles/random1.gfa",
     "-g testFiles/random1.gaf --sort-alignment"),
    ("evalGFA", "-f testFiles/random2.gfa", "-g testFiles/random2.gaf"),
    ("evalGFA", "-f testFiles/random2.gfa",
     "-g testFiles/random2.gaf --graph-statistics"),
    ("evalGFA", "-f testFiles/random2.gfa",
     "-g testFiles/random2.gaf --sort-alignment"),
    ("search", "-f testFiles/random3.gfa",
     "-n testFiles/random3.search_nodelist.tsv -s 1 -d 4"),
    ("filter", "-g testFiles/random3.gaf",
     "-n testFiles/random3.filter_nodelist.ls -o gaf"),
]


def gen_test(i: int, mode: str, input_arg: str, args: str, out_dir: pathlib.Path,
             run_dir: pathlib.Path, device=None) -> pathlib.Path:
    """Write validateFiles-format test.<i>.tst by running the in-process CLI
    from `run_dir` (where the testFiles/ symlink or copy lives)."""
    from .main import main

    cmdline = f"gfalign {mode} {input_arg} {args}".rstrip()
    argv = cmdline.split()[1:]
    old_cwd, old_stdout = os.getcwd(), sys.stdout
    buf = io.StringIO()
    try:
        os.chdir(run_dir)
        sys.stdout = buf
        main(argv, device=device)
    finally:
        os.chdir(old_cwd)
        sys.stdout = old_stdout
    tst = out_dir / f"test.{i}.tst"
    with open(tst, "w") as fh:
        fh.write(cmdline + "\nembedded\n")
        fh.write(buf.getvalue())
    return tst


def generate(test_files_dir: str, out_dir: str, device=None) -> list:
    from .main import resolve_device

    device = resolve_device(device or os.environ.get("GFALIGN_TORCH_DEVICE") or None)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for old in out.glob("*.tst"):
        old.unlink()
    run_dir = out.parent
    tf = run_dir / "testFiles"
    if not tf.exists():
        tf.symlink_to(pathlib.Path(test_files_dir).resolve())
    written = []
    for i, (mode, input_arg, args) in enumerate(MATRIX):
        written.append(gen_test(i, mode, input_arg, args, out, run_dir, device))
        print(f"generating: {written[-1]}")
    return written


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = [a for a in argv if a != "-y"]
    assume_yes = "-y" in argv
    if len(args) != 2:
        print(__doc__)
        return 2
    if not assume_yes:
        print("WARNING: only run this program if the program is in a working state")
        print("WARNING: previous validate files will be deleted")
        if input("continue? (Y/N) ").strip().lower() != "y":
            print("validate generation cancelled")
            return 0
    generate(args[0], args[1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
