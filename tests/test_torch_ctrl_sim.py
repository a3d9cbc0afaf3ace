"""The port's control-plane scale harness (``horovod_tpu_torch/ctrl_sim.py``)
against the JAX package's (``horovod_tpu/ctrl_sim.py``).

* ``_plan_hosts`` equals the JAX function over a grid of gang and host
  sizes;
* the frames ``_request_payload`` and ``_response_payload`` build are
  byte for byte the JAX module's for the same rank and cycle, and so is a
  sub-coordinator's ``TAG_TREE_UP`` aggregate of them;
* ``_decode_uplink`` gives the JAX function's result on both packages'
  ``TAG_REQUEST_LIST`` and ``TAG_TREE_UP`` frames (and on another tag);
* ``tests/test_ctrl_tree.py``'s two ``ctrl_sim`` cases on the port:
  ``simulate`` in both modes with its argument checks, and ``run_curve``'s
  keys with the tree samples observed into
  ``hvd_ctrl_cycle_seconds{ranks}``;
* the 256-rank tree-beats-star comparison, marked ``slow`` as the JAX
  one is.
"""

import statistics

import pytest

from horovod_tpu import ctrl_sim as jsim
from horovod_tpu.common import wire as jwire
from horovod_tpu.utils import socketutil as jsu

from horovod_tpu_torch import ctrl_sim
from horovod_tpu_torch.common import wire
from horovod_tpu_torch.telemetry import registry as tmx
from horovod_tpu_torch.utils import socketutil as su


@pytest.mark.parametrize("local_size", [1, 2, 3, 4, 8, 16])
def test_plan_hosts_equals_jax(local_size):
    for size in (1, 2, 3, 7, 8, 9, 16, 63, 64, 65, 256):
        assert ctrl_sim._plan_hosts(size, local_size) == \
            jsim._plan_hosts(size, local_size), (size, local_size)


def test_constants_equal_jax():
    assert ctrl_sim.CURVE_SIZES == jsim.CURVE_SIZES
    assert ctrl_sim.DEFAULT_LOCAL_SIZE == jsim.DEFAULT_LOCAL_SIZE
    assert su.TAG_REQUEST_LIST == jsu.TAG_REQUEST_LIST
    assert su.TAG_RESPONSE_LIST == jsu.TAG_RESPONSE_LIST
    assert su.TAG_TREE_UP == jsu.TAG_TREE_UP


@pytest.mark.parametrize("rank", [0, 1, 7, 255])
def test_payloads_byte_equal_jax(rank):
    for cycle in range(9):
        assert ctrl_sim._request_payload(rank, cycle) == \
            jsim._request_payload(rank, cycle), (rank, cycle)
        assert ctrl_sim._response_payload(cycle) == \
            jsim._response_payload(cycle), cycle


def _tree_up(pkg_wire, pkg_sim, ranks, cycle):
    return pkg_wire.encode_tree_up(
        [(r, su.TAG_REQUEST_LIST, pkg_sim._request_payload(r, cycle))
         for r in ranks], epoch=0)


def test_decode_uplink_equals_jax_on_both_packages_frames():
    cases = []
    for cycle in (0, 1, 5):
        for sim in (ctrl_sim, jsim):
            cases.append((su.TAG_REQUEST_LIST,
                          sim._request_payload(3, cycle)))
        ranks = list(range(8, 16))
        port_up = _tree_up(wire, ctrl_sim, ranks, cycle)
        jax_up = _tree_up(jwire, jsim, ranks, cycle)
        # A sub-coordinator's aggregate: the same bytes from either side.
        assert port_up == jax_up
        cases.append((su.TAG_TREE_UP, port_up))
        # An aggregate that also holds a heartbeat entry counts no list
        # for it.
        cases.append((su.TAG_TREE_UP, wire.encode_tree_up(
            [(8, su.TAG_REQUEST_LIST, ctrl_sim._request_payload(8, cycle)),
             (9, 5, b"")], epoch=0)))
    cases.append((su.TAG_RESPONSE_LIST, ctrl_sim._response_payload(0)))
    for tag, payload in cases:
        assert ctrl_sim._decode_uplink(tag, payload) == \
            jsim._decode_uplink(tag, payload), tag
    n, names = ctrl_sim._decode_uplink(su.TAG_TREE_UP, cases[2][1])
    assert n == 8 and len(names) == 16


def test_ctrl_sim_star_and_tree_cycles():
    star = ctrl_sim.simulate(8, mode="star", cycles=6, warmup=2)
    assert len(star) == 6 and all(s > 0 for s in star)
    tree = ctrl_sim.simulate(16, mode="tree", cycles=6, warmup=2,
                             local_size=4)
    assert len(tree) == 6 and all(s > 0 for s in tree)
    with pytest.raises(ValueError):
        ctrl_sim.simulate(8, mode="ring")
    with pytest.raises(ValueError):
        ctrl_sim.simulate(1)


def test_ctrl_sim_curve_exports_headline_and_observes_metric():
    tmx.configure(True)
    try:
        curve = ctrl_sim.run_curve(sizes=(8, 16), cycles=4, local_size=4)
        assert curve["coordination_cycle_p50_us"] == \
            curve["ctrl_cycle_tree_p50_us_16"]
        assert set(curve) == {"coordination_cycle_p50_us"} | {
            f"ctrl_cycle_{m}_p50_us_{n}" for m in ("star", "tree")
            for n in (8, 16)}
        for mode in ("star", "tree"):
            for size in (8, 16):
                assert curve[f"ctrl_cycle_{mode}_p50_us_{size}"] > 0
        hists = tmx.snapshot()["histograms"]
        series = [k for k in hists
                  if k.startswith("hvd_ctrl_cycle_seconds")]
        assert any('ranks="16"' in k for k in series), series
        # Three interleaved passes of four cycles per size.
        assert sum(hists[k]["count"] for k in series) == 2 * 3 * 4
    finally:
        tmx.configure(False)


@pytest.mark.slow
def test_ctrl_sim_256_rank_tree_beats_star():
    """The acceptance proof at full scale, as the JAX package's test: 256
    in-process ranks, the tree's p50 under the star's (median of three
    runs a mode)."""
    def p50(mode):
        runs = [statistics.median(
            ctrl_sim.simulate(256, mode=mode, cycles=20, warmup=5))
            for _ in range(3)]
        return statistics.median(runs)

    star, tree = p50("star"), p50("tree")
    assert tree < star, (tree, star)
