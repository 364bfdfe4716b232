"""Shared pytest config.

NOTE: no XLA_FLAGS here — smoke tests and benches must see ONE device;
only launch/dryrun.py (and subprocess tests driving it) force the
512/8-device placeholder fleet.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "slow: long-running (subprocess dry-runs, e2e)")
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA card (skips without one)")
