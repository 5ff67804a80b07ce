"""K1 and K2 (gfalign_torch/csrc/nw_path.cu) run on the CPU: the CUDA source
is built for the host with g++ and csrc/host_shim/cuda_runtime.h (a block's
threads as OS threads, barriers and shuffles as std::barrier exchanges) and
driven by the launchers of ops/nw_cuda.py with CPU tensors, so the kernels'
indexing, strip widths, candidate chunks, scratch hand-over, wavefront, rings
and super-strips are held bit-exact (tolerance 0) against the plain version,
which tests/test_torch_nw.py holds against the JAX package.  What nvcc
accepts and what the card computes is checked on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Skips without g++."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from gfalign_torch.ops import cuda_build, nw_cuda
from gfalign_torch.ops.nw_path import scores_prepared_ref


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the host")
    return nw_cuda._bind(ctypes.CDLL(str(cuda_build.build_host("nw_path"))))


def batch(seed, C, n, R, m, nodes, longest=None):
    """Ragged keys with an empty and a full candidate and read (pads -1/-2)."""
    rng = np.random.default_rng(seed)
    longest = m if longest is None else longest
    ak = (rng.integers(0, nodes, (C, n)) * 4 + rng.integers(0, 3, (C, n))).astype(np.int32)
    al = rng.integers(0, n + 1, (C,)).astype(np.int32)
    al[0], al[-1] = 0, n
    ak[np.arange(n)[None, :] >= al[:, None]] = -1
    bk = (rng.integers(0, nodes, (R, m)) * 4 + rng.integers(0, 2, (R, m))).astype(np.int32)
    bl = rng.integers(0, longest + 1, (R,)).astype(np.int32)
    bl[0], bl[-1] = 0, longest
    bk[np.arange(m)[None, :] >= bl[:, None]] = -2
    return [torch.from_numpy(x) for x in (ak, al, bk, bl)]


# (C, n, R, m, nodes, longest read, both orientations, TARGET_BLOCKS or None)
K1_CASES = {
    "search-like": (7, 8, 300, 16, 5, 15, True, None),
    "every-width": (9, 8, 1500, 16, 4, 15, True, None),
    "forward-only": (5, 12, 600, 5, 3, None, False, None),
    "candidate-chunks": (13, 8, 300, 16, 5, 15, True, 6),
    "m33": (4, 24, 260, 33, 4, None, True, None),
    "strips": (3, 40, 130, 70, 6, None, True, None),
    "strips-forward-chunks": (11, 20, 200, 64, 3, None, False, 6),
}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_on_the_host_matches_plain(case, host_lib, monkeypatch):
    C, n, R, m, nodes, longest, with_rc, target = K1_CASES[case]
    if target is not None:
        monkeypatch.setattr(nw_cuda, "TARGET_BLOCKS", target)
    ak, al, bk, bl = batch(1, C, n, R, m, nodes, longest)
    op = nw_cuda.ReadOperand(bk, bl, with_rc=with_rc)
    assert nw_cuda.uses_packed(n, m)
    out = torch.full((C, op.Rp), 12345, dtype=torch.int32)
    nw_cuda._launch_packed(host_lib, ak, al, op, out, None)
    assert torch.equal(out, scores_prepared_ref(ak, al, op))


def test_k1_scratch_cap_steps_over_candidates_and_rows(host_lib, monkeypatch):
    C, n, R, m = 11, 24, 400, 40
    monkeypatch.setattr(nw_cuda, "TARGET_BLOCKS", 6)
    monkeypatch.setattr(nw_cuda, "SCRATCH_BYTES", 4 * 2 * n * nw_cuda.BLOCK_R * 2)
    ak, al, bk, bl = batch(2, C, n, R, m, 4)
    op = nw_cuda.ReadOperand(bk, bl)
    before = nw_cuda.LAUNCHES["packed"]
    out = torch.full((C, op.Rp), 12345, dtype=torch.int32)
    nw_cuda._launch_packed(host_lib, ak, al, op, out, None)
    assert nw_cuda.LAUNCHES["packed"] - before > 2       # several wide launches
    assert torch.equal(out, scores_prepared_ref(ak, al, op))


# (C, n, R, m, nodes, both orientations, (K, T)); the JAX rule sends such
# short candidates to K1, so the launcher is driven directly
K2_CASES = {
    "one-warp": (2, 200, 3, 100, 5, True, (4, 32)),
    "ties": (6, 40, 12, 30, 2, True, (4, 32)),          # two nodes: up/left ties
    "three-warps": (2, 150, 2, 300, 5, True, (4, 96)),
    "K8": (3, 100, 2, 300, 3, False, (8, 64)),
    "K16": (2, 300, 2, 200, 4, True, (16, 32)),
    "ring-wraps": (2, 450, 2, 230, 4, True, (4, 64)),
    "super-strips": (2, 90, 2, 500, 4, True, (4, 64)),
    "three-super-strips": (2, 70, 1, 700, 3, False, (8, 32)),
}


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_on_the_host_matches_plain(case, host_lib, monkeypatch):
    C, n, R, m, nodes, with_rc, layout = K2_CASES[case]
    monkeypatch.setattr(nw_cuda, "split_layout", lambda longest, pairs: layout)
    ak, al, bk, bl = batch(3, C, n, R, m, nodes)
    op = nw_cuda.ReadOperand(bk, bl, with_rc=with_rc)
    before = nw_cuda.LAUNCHES["split"]
    out = nw_cuda._launch_split(host_lib, ak, al, op, None)
    assert nw_cuda.LAUNCHES["split"] == before + 1
    assert torch.equal(out, scores_prepared_ref(ak, al, op))
