"""Repo-wide pytest hooks: the `slow` marker, and the tests that carry it."""

from pathlib import Path

import pytest

# bench.py times at least 80 lazy-R1 steps at 512 channels on the 8-device
# CPU mesh: alone it took 957.8 s and 1081.2 s on 8 cores with a warm compile
# cache, and was cut at 600 s (2 cores) and 1500 s (8 cores, cold cache).
# Run it by hand: python -m pytest tests/test_bench_cli.py -m slow
SLOW = (
    ("tests/test_bench_cli.py", "test_bench_default_is_lazy_r1_window_recipe"),
)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: left out of the everyday run (-m 'not slow')")


def pytest_collection_modifyitems(config, items):
    slow = {(Path(__file__).parent / path, name) for path, name in SLOW}
    for item in items:
        if (item.path, item.originalname) in slow:
            item.add_marker(pytest.mark.slow)
