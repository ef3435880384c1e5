"""Shared pytest configuration.

Registers the ``requires_accel`` marker: tests that exercise real TPU/GPU
compilation paths (non-interpret Pallas lowering, full-slice meshes) carry it
and are skipped on CPU-only hosts, so the full suite collects green anywhere
while hardware CI still runs them.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "requires_accel: needs a real TPU/GPU device; skipped on CPU-only "
        "hosts (interpret-mode equivalents still run everywhere)")
    config.addinivalue_line(
        "markers",
        "requires_cuda: needs a CUDA card (the PyTorch port's kernels); "
        "skips inside the test where torch sees none")


def _accel_present() -> bool:
    try:
        import jax
        return jax.devices()[0].platform != "cpu"
    except Exception:
        return False


def pytest_collection_modifyitems(config, items):
    if _accel_present():
        return
    skip = pytest.mark.skip(
        reason="requires a TPU/GPU accelerator; CPU-only host")
    for item in items:
        if "requires_accel" in item.keywords:
            item.add_marker(skip)
