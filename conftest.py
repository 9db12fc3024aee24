"""Scheduling and a time limit for the tests under tests/ (the tier-1 suite).

pytest loads this file for every run from the repository's root; the hooks
below act on tests/ only.
"""

import contextlib
import pathlib
import signal
import time

import pytest

TESTS = pathlib.Path(__file__).resolve().parent / "tests"

# The files of tests/ over ~150 s on one worker, longest first, each with
# its seconds in a cold run of the tier-1 command (6 workers, no
# .jax_cache_cpu).  They are queued first, one a worker, so that none of
# them starts late and holds up the end of the run.  Keep to one file a
# worker: xdist hands a worker whose file has 2 or fewer tests
# (test_stress.py) the next file of the queue at once, and that file waits
# for the whole of it.
LONG_FIRST = (
    "test_stress.py",            # 973 s
    "test_chunk.py",             # 922 s
    "test_batch.py",             # 667 s
    "test_distributed.py",       # 383 s
    "test_loop_robustness.py",   # 336 s
    "test_deskew.py",            # 266 s
)

# A test under tests/ that runs longer than this fails.  About 1.6x the
# longest test of eight cold tier-1 runs, test_stress.py's corridor at
# 690 s (463-690 s across them).
# SIGALRM fires only between Python bytecodes: a call stuck inside XLA or
# torch is not cut until it returns.
TEST_TIME_LIMIT_S = 1100


def _in_tests(path) -> bool:
    return pathlib.Path(path).resolve().is_relative_to(TESTS)


def pytest_configure(config):
    # pytest-xdist queues files by test count, most first, unless told not
    # to; without it, the queue keeps the order set below.
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(items):
    """The files of LONG_FIRST first, in its order; every other file keeps
    its collected order (a stable sort)."""
    rank = {name: i for i, name in enumerate(LONG_FIRST)}
    items.sort(key=lambda item: rank.get(item.path.name, len(rank))
               if _in_tests(item.path) else len(rank))


@contextlib.contextmanager
def time_limit(seconds: float, what: str):
    """Fail `what` if the block runs longer than `seconds`.  Needs SIGALRM
    (POSIX), without which the block runs unbounded, and the main thread,
    where pytest-xdist 3.8 runs every test (execmodel main_thread_only).
    A limit set inside another one gives the outer one back what is left
    of its time when the block ends; the inner one should be the shorter."""
    if not hasattr(signal, "SIGALRM"):
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"{what} ran past the limit of {seconds} s", pytrace=False)

    old = signal.signal(signal.SIGALRM, expire)
    outer_left, _ = signal.setitimer(signal.ITIMER_REAL, seconds)
    start = time.monotonic()
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
        if outer_left:
            elapsed = time.monotonic() - start
            signal.setitimer(signal.ITIMER_REAL,
                             max(outer_left - elapsed, 1e-3))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    if not _in_tests(item.path):
        return (yield)
    with time_limit(TEST_TIME_LIMIT_S, item.nodeid):
        return (yield)
