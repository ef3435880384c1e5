"""A wall-clock limit on every test phase, for any pytest run from this root.

Each phase of a test (setup, call, teardown) gets ``TEST_TIME_LIMIT_S`` of
wall clock.  A phase past it fails with a message naming the test, the phase
and the limit, and the run goes on with the next test, so one hung test
cannot keep the clock of every test queued behind it.

The limit is a ``SIGALRM`` timer whose Python handler raises, so it stops
only code that returns to the interpreter: a wait inside native code (a torch
op, an XLA compile, a blocking C call) is not interrupted until it returns,
and code that catches ``BaseException`` can swallow it.  Under xdist every
worker runs its tests in its main thread, where the signal is delivered.
Where ``SIGALRM`` does not exist the hooks do nothing.
"""
import signal

import pytest

# About four times the slowest honest phase (a ~145 s call in
# tests/test_trace_golden.py with other files loading the CPU).
TEST_TIME_LIMIT_S = 600.0


class WallClockLimitExceeded(BaseException):
    """A test phase outran ``TEST_TIME_LIMIT_S``.

    Not an ``Exception`` nor pytest's ``Failed``: hypothesis takes either
    for a failing example and replays it to shrink, with the timer spent,
    so a hung property test would keep the run's clock.  pytest reports
    any other ``BaseException`` as the test's failure."""


def _limited(item, phase):
    """Hookwrapper body: arm the timer around one phase, disarm after."""
    if not hasattr(signal, "SIGALRM"):
        yield
        return
    limit = TEST_TIME_LIMIT_S

    def on_alarm(signum, frame):
        raise WallClockLimitExceeded(
            f"{item.nodeid}: {phase} exceeded its wall-clock limit of "
            f"{limit:g} s")

    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    yield from _limited(item, "setup")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    yield from _limited(item, "call")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item, nextitem):
    yield from _limited(item, "teardown")
