"""``transformer.train_loss`` and every leaf's gradient of M-RoPE
(qwen2-vl-7b's ``positions``), RG-LRU (recurrentgemma-2b) and RWKV6
(rwkv6-1.6b) against the JAX package's, on the CPU, as
tests/test_torch_train_grads.py holds the other families (its tolerances).
"""

import pytest

from test_torch_recurrent import one_torch_thread  # noqa: F401 — autouse
from test_torch_train_grads import check_family

# jits the JAX model; the quick tier skips it with -m "not slow"
pytestmark = pytest.mark.slow

ARCHS = {
    "qwen2-vl-reduced": dict(arch="qwen2-vl-7b"),
    "recurrentgemma-reduced": dict(arch="recurrentgemma-2b"),
    "rwkv6-reduced": dict(arch="rwkv6-1.6b"),
}


@pytest.mark.parametrize("variant", list(ARCHS))
def test_train_loss_and_grads_match_repro(variant):
    check_family(ARCHS[variant])
