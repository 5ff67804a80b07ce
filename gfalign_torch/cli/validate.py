"""Standalone golden-output validator (the reference's gfalign-validate
binary, src/validate.cpp) for the port: walk directories for .tst files,
run each file's line-1 command through gfalign_torch.cli.main, line-diff
stdout against the embedded expectation (or an expected-output file named
on line 2), print a colored PASS/FAIL per test and the first differing
line of a failure, exit 0 iff all pass (1 when one fails, 2 on a usage
error or when the scoring device is unavailable).

    gfalign-torch-validate <dir-or-tst> [more...]

Commands score on CUDA unless GFALIGN_TORCH_DEVICE=cpu is set.  They run
with CWD = the directory containing the .tst file's parent (so the
reference's 'gfalign evalGFA -f testFiles/...' lines work when
validateFiles/ and testFiles/ are siblings, as in the reference repo).
"""

from __future__ import annotations

import io
import os
import pathlib
import shlex
import sys
from typing import List

GREEN = "\033[32m"
RED = "\033[31m"
RESET = "\033[0m"


def run_tst(tst: pathlib.Path, device=None) -> bool:
    from .main import main

    lines = tst.read_text().split("\n")
    command = lines[0]
    argv = shlex.split(command)
    if argv and argv[0].endswith("gfalign"):
        argv = argv[1:]
    if lines[1] == "embedded":
        expected = "\n".join(lines[2:])
    else:
        expected = (tst.parent / lines[1]).read_text()

    # run in a scratch dir mirroring the .tst's repo root (symlinks), so
    # commands that write files (e.g. `filter -o gaf`) work even when the
    # source tree is read-only
    import tempfile

    root = tst.parent.parent
    old_cwd, old_stdout = os.getcwd(), sys.stdout
    buf = io.StringIO()
    code = 1
    with tempfile.TemporaryDirectory(prefix="gfalign-validate-") as tmp:
        workdir = pathlib.Path(tmp)
        for entry in root.iterdir():
            try:
                (workdir / entry.name).symlink_to(entry)
            except OSError:
                pass
        try:
            os.chdir(workdir)
            sys.stdout = buf
            code = main(argv, device=device)
        except SystemExit as exc:
            code = int(exc.code or 0)
        except Exception as exc:  # a crash is a FAIL, not an abort
            print(f"error running {tst.name}: {exc}", file=sys.stderr)
        finally:
            os.chdir(old_cwd)
            sys.stdout = old_stdout

    ok = code == 0 and buf.getvalue().split("\n") == expected.split("\n")
    color = GREEN if ok else RED
    print(f"{color}{'PASS' if ok else 'FAIL'}{RESET}: {tst}")
    if not ok and code == 0:
        got, want = buf.getvalue().split("\n"), expected.split("\n")
        for i in range(max(len(got), len(want))):
            g = got[i] if i < len(got) else "<missing>"
            w = want[i] if i < len(want) else "<missing>"
            if g != w:
                print(f"  line {i + 1}: got      {g!r}")
                print(f"  line {i + 1}: expected {w!r}")
                break
    return ok


def main(argv: List[str] | None = None) -> int:
    from .main import resolve_device

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: gfalign-torch-validate <dir-or-tst> [more...]", file=sys.stderr)
        return 2
    tsts: List[pathlib.Path] = []
    for arg in argv:
        p = pathlib.Path(arg)
        if p.is_dir():
            tsts.extend(sorted(p.rglob("*.tst")))
        elif p.is_file():
            tsts.append(p)
        else:
            print(f"no such file or directory: {arg}", file=sys.stderr)
            return 2
    if not tsts:
        print("no .tst files found", file=sys.stderr)
        return 2
    try:
        device = resolve_device(os.environ.get("GFALIGN_TORCH_DEVICE") or None)
    except RuntimeError as exc:
        print(str(exc), file=sys.stderr)
        return 2
    results = [run_tst(t, device) for t in tsts]
    print(f"{sum(results)}/{len(results)} passed")
    return 0 if all(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
