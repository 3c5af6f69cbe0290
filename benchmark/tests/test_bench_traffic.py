"""The bulk traffic: one seed gives one traffic; every seed gives the same
set of segment lengths, in another order and with other sound."""
import itertools

import numpy as np

from benchmark.traffic import bulk_files

PARAMS = {"file_seconds": [20, 30], "burst_s": [2.0, 6.0],
          "pause_s": [0.9, 3.0], "layout_seed": 17, "sample_files": 2}


def bursts(wave):
    nz = np.flatnonzero(wave != 0)
    cuts = np.flatnonzero(np.diff(nz) > 1600)   # gaps over 0.1 s
    return list(zip(np.r_[nz[0], nz[cuts + 1]], np.r_[nz[cuts], nz[-1]]))


def test_same_seed_same_traffic():
    a = bulk_files.pool(PARAMS, 2147483647 + 5)
    b = bulk_files.pool(PARAMS, 2147483647 + 5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    oa = list(itertools.islice(bulk_files.passes(2, 2147483652), 5))
    ob = list(itertools.islice(bulk_files.passes(2, 2147483652), 5))
    assert oa == ob


def test_seeds_share_the_layout():
    a = bulk_files.pool(PARAMS, 1)
    b = bulk_files.pool(PARAMS, 2)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        assert not np.array_equal(x, y)
        bx, by = bursts(x), bursts(y)
        assert len(bx) == len(by)
        assert all(abs(int(s0) - int(s1)) < 400
                   and abs(int(e0) - int(e1)) < 400
                   for (s0, e0), (s1, e1) in zip(bx, by))


def test_files_are_on_the_pcm_grid_and_end_in_silence():
    for wave in bulk_files.pool(PARAMS, 3):
        assert np.array_equal(np.round(wave * 32768) / 32768, wave)
        assert not wave[-int(0.9 * 16000):].any()


def test_every_pass_serves_every_file():
    it = bulk_files.passes(6, 99)
    for _ in range(3):
        assert sorted(next(it)) == list(range(6))
