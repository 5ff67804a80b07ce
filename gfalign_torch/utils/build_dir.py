"""Where the port puts what it compiles at first use (the native host
runtime, io/native.py; the CUDA sources, ops/cuda_build.py).

In a source checkout (the package's parent holds pyproject.toml) that is
build/gfalign_torch/ beside the sources, as it has always been.  An
installed package must not write into site-packages, so there it is the
user's cache, $XDG_CACHE_HOME/gfalign_torch/ (default ~/.cache), one
directory per compiler command line: the key holds a hash of the flags,
so two builds with other flags never load each other's library.  The
cache directories are made with mode 0o700, and one found with looser
permissions is tightened, so another local user cannot plant a library
there.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
from typing import Sequence

PACKAGE = pathlib.Path(__file__).resolve().parents[1]


def in_checkout(package: pathlib.Path = PACKAGE) -> bool:
    """Whether the package sits in a source checkout of the repository."""
    return (package.parent / "pyproject.toml").is_file()


def cache_root() -> pathlib.Path:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return pathlib.Path(base) / "gfalign_torch"


def build_dir(kind: str, flags: Sequence[str],
              package: pathlib.Path = PACKAGE) -> pathlib.Path:
    """The directory for `kind`'s libraries ("native", "cuda"), built with
    the compiler command line `flags`; nothing is created here."""
    if in_checkout(package):
        root = package.parent / "build" / "gfalign_torch"
        return root / "native" if kind == "native" else root
    key = hashlib.sha256("\0".join(flags).encode()).hexdigest()[:16]
    return cache_root() / f"{kind}-{key}"


def make_dir(path: pathlib.Path) -> pathlib.Path:
    """Create `path` (and its parents); inside the user's cache every level
    from gfalign_torch/ down is mode 0o700 and owned by this user."""
    path.mkdir(parents=True, exist_ok=True, mode=0o700)
    root = cache_root()
    if path == root or root in path.parents:
        for level in [path, *path.parents]:
            st = level.stat()
            if st.st_uid != os.getuid():
                raise RuntimeError(f"{level} belongs to another user")
            if st.st_mode & 0o077:
                os.chmod(level, 0o700)
            if level == root:
                break
    return path
