"""The root conftest.py's `slow` mark still lands on bench.py's lazy-R1 test.

The mark is matched by file and test name, so a rename of the test would
quietly bring it back into `-m 'not slow'`; these collect-only runs catch that.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAZY = "tests/test_bench_cli.py::test_bench_default_is_lazy_r1_window_recipe"
PARITY = "tests/test_bench_cli.py::test_bench_parity_interval_one"


@pytest.mark.parametrize("marks, expected", [("not slow", [PARITY]), ("slow", [LAZY])])
def test_slow_mark_selects_only_the_lazy_bench_test(marks, expected):
    from tests.conftest import require_live_jax_subprocess
    require_live_jax_subprocess()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-p", "no:cacheprovider",
         "tests/test_bench_cli.py", "-m", marks],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert [line for line in proc.stdout.splitlines() if "::" in line] == expected
