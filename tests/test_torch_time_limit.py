"""The per-test wall-clock limit of the repo's root ``conftest.py``, held in
a run of its own.

The inner run loads the limit's hooks from that file with the limit patched
down to 1 s; it runs in a subprocess because the limit's timer is one per
process.  Its hypothesis case is built only where hypothesis imports, since
the suite treats hypothesis as optional.
"""
import importlib.util
from pathlib import Path

pytest_plugins = "pytester"

CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"
HAS_HYPOTHESIS = importlib.util.find_spec("hypothesis") is not None

INNER_CONFTEST = f"""
import importlib.util

_spec = importlib.util.spec_from_file_location("limit_hooks", {str(CONFTEST)!r})
_limit = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_limit)
_limit.TEST_TIME_LIMIT_S = 1.0

pytest_runtest_setup = _limit.pytest_runtest_setup
pytest_runtest_call = _limit.pytest_runtest_call
pytest_runtest_teardown = _limit.pytest_runtest_teardown
"""

INNER_TESTS = """
import time

import pytest


@pytest.fixture
def slow_fixture():
    time.sleep(30)


def test_sleeps_past_limit():
    time.sleep(30)


def test_setup_sleeps_past_limit(slow_fixture):
    pass


def test_runs_after():
    assert True
"""

INNER_PROPERTY_TEST = """
from hypothesis import given, settings, strategies as st


@settings(max_examples=5, deadline=None, database=None)
@given(st.integers())
def test_property_sleeps_past_limit(x):
    time.sleep(30)
"""


def test_hung_phases_fail_alone_and_the_run_goes_on(pytester):
    hung = [("test_sleeps_past_limit", "call"),
            ("test_setup_sleeps_past_limit", "setup")]
    tests = INNER_TESTS
    if HAS_HYPOTHESIS:
        tests += INNER_PROPERTY_TEST
        hung.append(("test_property_sleeps_past_limit", "call"))
    pytester.makeconftest(INNER_CONFTEST)
    pytester.makepyfile(test_inner=tests)
    result = pytester.runpytest_subprocess(
        "-v", "-p", "no:cacheprovider", "-p", "no:xdist", timeout=120)
    result.assert_outcomes(passed=1, failed=len(hung) - 1, errors=1)
    result.stdout.fnmatch_lines(["*::test_runs_after PASSED*"])
    out = result.stdout.str()
    for name, phase in hung:
        assert (f"test_inner.py::{name}: {phase} exceeded its wall-clock "
                f"limit of 1 s") in out
