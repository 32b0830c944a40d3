import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    """Skip here unless a CUDA card is present (decided when the test
    runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip: python -m pytest "
                    "portbench/tests -m gpu")
    return torch.device("cuda", 0)
