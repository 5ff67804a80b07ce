"""The two-axis scoring step (gfalign_torch/parallel/mesh.py and
score_step.sharded_scoring_step) on the CPU: the grid and the padding
equal the JAX package's, and the step on 1, 2 and 4 gloo ranks gives the
exact int tallies of gfalign_tpu.parallel.score_step.sharded_scoring_step
on the 8-device CPU mesh (tests/conftest.py's XLA_FLAGS), on every rank
and on every grid of the world size."""

import functools
import json
import pathlib

import numpy as np
import pytest

from gfalign_tpu.parallel import mesh as jax_mesh
from gfalign_tpu.parallel import score_step as jax_score_step
from gfalign_torch.dryrun import _example_batch
from gfalign_torch.parallel import dist, mesh
from gfalign_torch.parallel.score_step import local_step, pad_for_mesh, sharded_scoring_step

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPAWN_SECONDS = 120

RANK_BODY = """
import json, sys
import numpy as np
from gfalign_torch.parallel import dist
from gfalign_torch.parallel.score_step import sharded_scoring_step
dist.init_if_requested()
rank, count = dist.process_info()
spec = json.load(open(sys.argv[1]))
out = {}
for name in spec["batches"]:
    z = np.load(spec["dir"] + "/" + name + ".npz")
    for grid in spec["grids"]:
        got = sharded_scoring_step(z["a_keys"], z["a_len"], z["b_keys"], z["b_len"],
                                   grid=tuple(grid), device="cpu")
        out[f"{name} {grid[0]}x{grid[1]}"] = got.tolist()
json.dump(out, open(f"{spec['dir']}/rank{rank}.json", "w"))
"""


def ragged_batch(seed, C=13, n=12, R=37, m=9, nodes=10):
    """Ragged keys with pads (-1 / -2), empty reads and candidates whose
    count is no multiple of any axis."""
    rng = np.random.default_rng(seed)

    def keys(rows, width, pad, orients):
        k = (rng.integers(0, nodes, (rows, width)) * 4
             + rng.integers(0, orients, (rows, width))).astype(np.int32)
        lens = rng.integers(0, width + 1, rows).astype(np.int32)
        lens[::5] = 0
        return np.where(np.arange(width)[None] < lens[:, None], k, pad).astype(np.int32), lens

    a_keys, a_len = keys(C, n, -1, 3)
    a_len[a_len == 0] = 1
    a_keys[:, 0] = np.where(a_keys[:, 0] < 0, 4, a_keys[:, 0])
    b_keys, b_len = keys(R, m, -2, 2)
    return a_keys, a_len, b_keys, b_len


BATCHES = {"example": _example_batch(), "ragged0": ragged_batch(0),
           "ragged1": ragged_batch(1, C=40, n=20, R=70, m=16)}


@functools.lru_cache(maxsize=None)
def jax_tallies(name):
    """The JAX step (its jitted scorer) on the 8-device CPU mesh, cut to
    the caller's C."""
    import jax

    a_keys, a_len, b_keys, b_len = BATCHES[name]
    m8 = jax_mesh.make_mesh(8)
    assert len(jax.devices()) >= 8 and dict(m8.shape) == {"data": 2, "cand": 4}
    ak, al = jax_score_step.pad_for_mesh(a_keys, a_len, m8.shape["cand"], -1)
    bk, bl = jax_score_step.pad_for_mesh(b_keys, b_len, m8.shape["data"], -2)
    out = jax_score_step.make_sharded_scorer(m8)(ak, al, bk, bl)
    return np.asarray(out)[:a_keys.shape[0]]


def test_grid_and_padding_match_jax():
    for n in range(1, 17):
        assert mesh.default_mesh_shape(n) == jax_mesh.default_mesh_shape(n), n
        d, c = mesh.default_mesh_shape(n)
        assert [mesh.grid_position(p, (d, c)) for p in range(n)] == \
            [(p // c, p % c) for p in range(n)]
    rng = np.random.default_rng(3)
    for rows in (0, 1, 5, 8, 13):
        arr = rng.integers(-2, 40, (rows, 7)).astype(np.int32)
        lens = rng.integers(0, 8, rows).astype(np.int32)
        for shards in (1, 2, 3, 4, 8):
            got = pad_for_mesh(arr, lens, shards, -2)
            want = jax_score_step.pad_for_mesh(arr, lens, shards, -2)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        mesh.grid_position(4, (2, 2))


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_one_process_step_is_local_step_and_matches_jax(name):
    import torch

    batch = BATCHES[name]
    want = jax_tallies(name)
    got = sharded_scoring_step(*batch, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    local = local_step(*(torch.from_numpy(x) for x in batch), filter_alignments=True)
    np.testing.assert_array_equal(local.numpy(), want)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        sharded_scoring_step(*batch, grid=(2, 2), device="cpu")


@pytest.mark.parametrize("nproc,grids", [
    (2, [(1, 2), (2, 1)]),
    (4, [(2, 2), (1, 4), (4, 1)])])
def test_ranks_match_the_jax_mesh_exactly(nproc, grids, tmp_path):
    assert mesh.default_mesh_shape(nproc) == grids[0]
    for name, batch in BATCHES.items():
        np.savez(tmp_path / f"{name}.npz", a_keys=batch[0], a_len=batch[1],
                 b_keys=batch[2], b_len=batch[3])
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"dir": str(tmp_path), "batches": sorted(BATCHES),
                                "grids": grids}))
    script = tmp_path / "rank.py"
    script.write_text(RANK_BODY)
    got = dist.launch_local([script, spec], nproc, SPAWN_SECONDS, tmp_path, cwd=ROOT,
                            env={"PYTHONPATH": str(ROOT)})
    assert [rc for rc, _, _ in got] == [0] * nproc, [err[-800:] for _, _, err in got]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(nproc)]
    for name in BATCHES:
        want = jax_tallies(name)
        for grid in grids:
            key = f"{name} {grid[0]}x{grid[1]}"
            for r in range(nproc):
                np.testing.assert_array_equal(np.asarray(ranks[r][key]), want,
                                              err_msg=f"rank {r} {key}")
