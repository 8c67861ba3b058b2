import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips in its body "
        "where torch sees none (run on the card with `pytest -m gpu`)")
