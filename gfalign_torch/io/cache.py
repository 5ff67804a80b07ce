"""Packed-tensor cache for repeated loads (SURVEY.md section 5: real
curation workloads reload the same GFA/GAF many times across the
align -> filter -> search -> evalPath stages).

Set GFALIGN_TORCH_CACHE=<dir> to cache GAF parses as .npz bundles keyed by
(path, size, mtime); a hit skips tokenization and parsing entirely.
Disabled by default (no env var) — the reference pipeline's file-based
stage contract is unchanged.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
from typing import Optional

import numpy as np


def cache_dir() -> Optional[pathlib.Path]:
    d = os.environ.get("GFALIGN_TORCH_CACHE")
    if not d:
        return None
    p = pathlib.Path(d)
    p.mkdir(parents=True, exist_ok=True)
    return p


def _key(path: str) -> Optional[str]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    raw = f"{os.path.abspath(path)}|{st.st_size}|{st.st_mtime_ns}"
    return hashlib.sha256(raw.encode()).hexdigest()[:24]


def load_gaf_cache(path: str):
    """Cached (numeric, qnames, paths, tails, tokens) or None."""
    d = cache_dir()
    if d is None:
        return None
    key = _key(path)
    if key is None:
        return None
    f = d / f"gaf-{key}.npz"
    if not f.exists():
        return None
    try:
        data = np.load(f, allow_pickle=False)
        from .native import GafTokens, RaggedStrings

        count = int(data["numeric"].shape[0])

        def names_list(name):
            s = data[name].tobytes().decode("utf-8")
            parts = s.split("\n")
            if parts and parts[-1] == "":
                parts.pop()
            return parts

        def ragged(name):
            return RaggedStrings.from_blob(data[name].tobytes(), count)

        tokens = GafTokens(data["step_ids"], data["step_orients"],
                           data["offsets"], names_list("dict_names"))
        return (data["numeric"], ragged("qnames"), ragged("paths"),
                ragged("tails"), tokens)
    except Exception:
        return None


def store_gaf_cache(path: str, numeric, qnames, paths, tails, tokens) -> None:
    d = cache_dir()
    if d is None or tokens is None:
        return
    key = _key(path)
    if key is None:
        return
    f = d / f"gaf-{key}.npz"
    tmp = f.with_suffix(f".{os.getpid()}.tmp.npz")

    def blob(parts):
        starts = getattr(parts, "starts", None)
        if starts is not None:
            # contiguous lazy column: reuse its backing blob verbatim
            ends = parts.ends
            if (len(starts) == 0
                    or (starts[0] == 0 and np.all(starts[1:] == ends[:-1] + 1)
                        and int(ends[-1]) == len(parts.blob) - 1)):
                return np.frombuffer(parts.blob, dtype=np.uint8)
        return np.frombuffer(("\n".join(parts) + "\n").encode("utf-8"),
                             dtype=np.uint8)

    try:
        np.savez(tmp, numeric=numeric, qnames=blob(qnames), paths=blob(paths),
                 tails=blob(tails), step_ids=tokens.step_ids,
                 step_orients=tokens.step_orients, offsets=tokens.offsets,
                 dict_names=blob(tokens.names))
        os.replace(tmp, f)
    except Exception:
        if tmp.exists():
            tmp.unlink()
