"""The tier-1 suite's own scheduling and waits (the root conftest.py,
tests/torch_ranks.py): the long files are queued first, every test has a
time limit below the suite's, and run_ranks waits once for all its ranks."""

import pathlib
import time
import types

import pytest

import conftest
from tests.torch_ranks import GLOO_TIMEOUT_S, JOIN_TIMEOUT_S, run_ranks

TESTS = pathlib.Path(__file__).parent
SUITE_LIMIT_S = 1470     # the tier-1 command's own timeout
WORKERS = 6              # its -n


def test_long_first_files_exist_once():
    assert len(set(conftest.LONG_FIRST)) == len(conftest.LONG_FIRST)
    assert len(conftest.LONG_FIRST) <= WORKERS
    for name in conftest.LONG_FIRST:
        assert (TESTS / name).is_file(), name


def test_long_first_files_run_first_in_order():
    first = list(conftest.LONG_FIRST)
    collected = (["test_z.py", first[-1], "test_a.py", first[0], "test_z.py"]
                 + first[1:-1] + [first[-1]])
    items = [types.SimpleNamespace(path=TESTS / name, k=k)
             for k, name in enumerate(collected)]
    conftest.pytest_collection_modifyitems(items)
    assert [item.path.name for item in items] == (
        first + [first[-1], "test_z.py", "test_a.py", "test_z.py"])
    # a stable sort: the items of a file keep their collected order
    assert [item.k for item in items][-4:] == [len(collected) - 1, 0, 2, 4]


def test_long_first_leaves_files_outside_tests_in_place():
    other = TESTS.parent / "slam_bench" / "tests"
    items = [types.SimpleNamespace(path=other / name)
             for name in ("test_z.py", conftest.LONG_FIRST[0])]
    conftest.pytest_collection_modifyitems(items)
    assert [item.path.name for item in items] == [
        "test_z.py", conftest.LONG_FIRST[0]]


def test_xdist_reorder_is_off():
    config = types.SimpleNamespace(
        option=types.SimpleNamespace(loadscopereorder=True))
    conftest.pytest_configure(config)
    assert config.option.loadscopereorder is False
    conftest.pytest_configure(types.SimpleNamespace(
        option=types.SimpleNamespace()))     # without xdist: nothing to do


def test_time_limit_lies_below_the_suite_limit():
    assert 0 < conftest.TEST_TIME_LIMIT_S < SUITE_LIMIT_S


def test_time_limit_fails_a_test_that_runs_past_it():
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="ran past the limit of 1 s"):
        with conftest.time_limit(1, "a stand-in test"):
            time.sleep(10)
    assert time.monotonic() - t0 < 5


def test_time_limit_gives_the_outer_limit_back():
    """An inner limit that ends in time leaves the outer one armed with
    what is left of its time."""
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="outer ran past"):
        with conftest.time_limit(1.5, "outer"):
            with conftest.time_limit(10, "inner"):
                time.sleep(0.5)
            time.sleep(10)
    assert 1.4 < time.monotonic() - t0 < 5


def test_run_ranks_waits_one_deadline_for_all_ranks():
    """A stuck world of 4 ranks is given up after join_timeout in all, not
    after join_timeout for each rank in turn."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="ran past 0.5 s"):
        run_ranks(lambda comm: time.sleep(10), 4, join_timeout=0.5)
    assert time.monotonic() - t0 < 1.5


def test_a_hung_collective_fails_before_run_ranks_gives_up():
    """gloo's own error names the collective that hung; run_ranks' deadline
    must leave it the time to be raised."""
    assert JOIN_TIMEOUT_S > GLOO_TIMEOUT_S
