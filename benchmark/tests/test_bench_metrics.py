"""The arithmetic of the per-layer metrics, the trace reduction and the
roofline yardstick, on fixed inputs."""

import pytest

from benchmark import common, roofline, trace

ALIGN_OBS = {"mode": "align", "reads": 500, "calls_wall_s": 10.0,
             "phase_s": {"seeding": 2.0, "scoring": 1.0, "traceback": 4.0},
             "work": {"k3": roofline.banded_work([10000] * 100, 128)},
             "slice": {"busy_s": 0.5, "window_s": 5.0,
                       "kernels": {"banded_fwd_kernel": 0.01,
                                   "banded_rows_kernel": 0.0001,
                                   "aten::copy": 1.0}}}
SEARCH_OBS = {"mode": "search", "searches": 2, "search_wall_s": 10.0,
              "evaluate_s": 4.0, "frontier_calls": 4000,
              "work": {"k1": roofline.path_work([8] * 100, [16] * 1000)},
              "slice": {"busy_s": 0.2, "window_s": 1.0,
                        "kernels": {"nw_fwd_packed_narrow": 0.01}}}


@pytest.mark.parametrize("name,obs,want", [
    ("align.seeding_ms_per_read", ALIGN_OBS, 4.0),
    ("align.scoring_ms_per_read", ALIGN_OBS, 2.0),
    ("align.traceback_ms_per_read", ALIGN_OBS, 8.0),
    ("align.other_ms_per_read", ALIGN_OBS, 6.0),
    ("align.device_idle", ALIGN_OBS, 90.0),
    ("search.driver_ms_per_call", SEARCH_OBS, 1.5),
    ("search.evaluate_ms_per_call", SEARCH_OBS, 1.0),
    ("search.device_idle", SEARCH_OBS, 80.0),
])
def test_reader_arithmetic(name, obs, want):
    assert common.load_reader(name).read(obs) == pytest.approx(want)


def test_k3_roofline():
    # 100 pairs x 10,000 rows x 128 lanes x 8 ops = 1.024e9 ops
    least = 1.024e9 / roofline.INT32_OPS_PER_S
    got = common.load_reader("align.k3_roofline").read(ALIGN_OBS)
    assert got == pytest.approx(100 * least / 0.0101)


def test_k1_roofline():
    # 2 orientations x 800 x 16,000 cells x 8 ops
    least = 2 * 800 * 16000 * 8 / roofline.INT32_OPS_PER_S
    got = common.load_reader("search.k1_roofline").read(SEARCH_OBS)
    assert got == pytest.approx(100 * least / 0.01)


def test_roofline_is_silent_without_work_or_time():
    assert roofline.share({}, 1.0) is None
    assert roofline.share(roofline.banded_work([100], 128), 0.0) is None
    obs = dict(SEARCH_OBS, slice=dict(SEARCH_OBS["slice"], kernels={}))
    assert common.load_reader("search.k1_roofline").read(obs) is None
    assert common.load_reader("align.k3_roofline").read(SEARCH_OBS) is None


def test_least_time_takes_the_larger_bound():
    assert roofline.least_time(16.7e12, 0) == pytest.approx(16.7e12 / roofline.INT32_OPS_PER_S)
    assert roofline.least_time(0, 3.35e12) == pytest.approx(1.0)


def test_live_rows():
    import numpy as np

    pool = np.full((3, 8), roofline.PAD_CODE, np.int8)  # three reads
    pool[0, :5] = 1
    pool[1, :2] = 0
    pool[1, 6] = 3          # a masked stretch inside the read
    assert roofline.live_rows(pool, [0, 1, 2, 0]).tolist() == [5, 7, 0, 5]


def test_trace_reduction():
    ev = [("k1", "CUDA", 0, 100), ("k2", "CUDA", 50, 100),
          ("k1", "CUDA", 400, 100), ("memcpy", "CUDA", 1000, 50),
          ("aten::mm", "CPU", 0, 1000), ("cudaLaunch", "CPU", 250, 50)]
    got = trace.reduce_events(ev, 2e-6)
    assert got["busy_s"] == pytest.approx(300e-9)
    assert got["kernels"]["k1"] == pytest.approx(200e-9)
    assert got["breakdown"]["device_ops"][0] == ["k1", 200e-9]
    gaps = got["breakdown"]["idle_gaps"]
    assert gaps[0] == ["aten::mm", 500e-9]          # 500..1000
    assert gaps[1] == ["cudaLaunch", 250e-9]        # 150..400, mid 275
