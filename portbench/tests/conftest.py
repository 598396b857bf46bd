"""The benchmark's own tests: the reference against the port on small
clusters, the manifest's rules, the import guard, and the controls and
faults that must come out not correct. Tests marked ``card`` need a CUDA
device and skip without one (decided inside the fixture)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
os.environ["TZ"] = "Asia/Shanghai"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (run on the chip)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda:0"
