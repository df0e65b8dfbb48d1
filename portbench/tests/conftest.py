import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    """Skips a test where no CUDA device is present (decided at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 4))
    yield
    torch.set_num_threads(prev)
