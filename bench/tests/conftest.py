"""The benchmark's own tests: the harness's and the reference's
directories on the path, and the marker of the tests that need a GPU."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the CPU tests' sizes: the program's ``ModelConfig.reduced()`` widths
# (d_model 256, heads 8 and 4 of width 32, FFN 512, vocabulary 512, two
# layers, float32; the SSM's state 16, head 32, chunk 32) and 1 x 32
# tokens a node
SMALL = {
    "dense_decoder": dict(hidden_size=256, num_attention_heads=8,
                          num_key_value_heads=4, head_dim=32,
                          intermediate_size=512, vocab_size=512,
                          num_hidden_layers=2, torch_dtype="float32"),
    "mamba2": dict(hidden_size=256, state_size=16, head_dim=32,
                   chunk_size=32, vocab_size=512, num_hidden_layers=2,
                   torch_dtype="float32"),
}
SMALL_TRAFFIC = dict(seq_len=32, rows_per_node=1, pool_batches=4)
# whole runs, many of them: widths a quarter of those
TINY = {
    "dense_decoder": dict(SMALL["dense_decoder"], hidden_size=64,
                          num_attention_heads=4, num_key_value_heads=2,
                          head_dim=16, intermediate_size=128,
                          vocab_size=128),
    "mamba2": dict(SMALL["mamba2"], hidden_size=64, head_dim=16,
                   chunk_size=16, vocab_size=128),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on an NVIDIA GPU; skips on a machine "
        "without one")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the shapes are small and the suite's
    workers share the machine's cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
