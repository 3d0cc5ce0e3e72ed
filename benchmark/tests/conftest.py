"""Tests of the benchmark's harness. Those that need the CUDA card carry the
``card`` marker and decide inside the test whether a card is there; run
them on the card with ``python3 -m pytest benchmark/tests -m card``."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the CUDA card (skips without one)")
