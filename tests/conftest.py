import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "sm90: needs an NVIDIA Hopper (sm_90) card and nvcc; "
        "skips elsewhere")
