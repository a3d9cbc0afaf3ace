"""The classic torch front-end and the bridge on the card: two port ranks
sharing cuda:0 (``tests/torch_port_frontend_worker.py``'s ``card_*``
cases, ``FRONTEND_DEVICE=cuda:0``).  Marked ``cuda``: they skip where
torch finds no CUDA device.  This file imports no JAX.

* the in-place forms keep the caller's CUDA storage (the same tensor, the
  same data pointer, on cuda:0) and give the bits of the same op on host
  copies, in fp32 and bf16;
* the gradient-order race: a 24-layer backward whose last layer's
  gradients finish first, so that the hooks enqueue them while the earlier
  layers' kernels are still queued; every averaged gradient must be the
  bits of the ranks' own gradients (taken without hooks) averaged
  afterwards, in four iterations;
* the gradients' ``grouped_allreduce`` compiled with the default backend
  on cuda:0, bit for bit the eager one's, with no graph break.
"""

import time

import pytest
import torch

from test_torch_frontend import finish_gang, ran, start_gang, value

CARD_CASES = ["card_inplace", "card_race", "card_compile"]


@pytest.fixture(scope="module")
def card_gang(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    d = str(tmp_path_factory.mktemp("frontend_card"))
    gang = start_gang(["port", "port"], CARD_CASES, d,
                      {"FRONTEND_DEVICE": "cuda:0"})
    return finish_gang(*gang, d, time.monotonic() + 600.0)


@pytest.mark.cuda
@pytest.mark.timeout(700)
def test_card_in_place_ops_keep_the_callers_storage(card_gang):
    ran(card_gang, "card_inplace")
    for rank in range(2):
        res = card_gang[1][rank]["card_inplace"]
        for key in res:
            assert value(card_gang, rank, "card_inplace", key).item(), \
                (rank, key)


@pytest.mark.cuda
@pytest.mark.timeout(700)
def test_card_hook_gradients_are_never_torn(card_gang):
    ran(card_gang, "card_race")
    for rank in range(2):
        assert value(card_gang, rank, "card_race", "torn").item() == 0


@pytest.mark.cuda
@pytest.mark.timeout(700)
def test_card_compiled_reduction(card_gang):
    ran(card_gang, "card_compile")
    for rank in range(2):
        assert value(card_gang, rank, "card_compile", "on_card").item()
        assert value(card_gang, rank, "card_compile", "bits").item()
        assert value(card_gang, rank, "card_compile",
                     "graph_breaks").item() == 0
