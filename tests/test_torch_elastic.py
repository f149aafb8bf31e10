"""The port's elastic plans (``repro_torch.train.elastic``) vs the JAX
package's, and the searcher fleet of ``tests/test_elastic_serving.py`` over
a port index saved and reloaded: lose a host, replan, reload its shards,
keep serving with identical answers."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import LannsConfig as JConfig
from repro.core import LannsIndex as JIndex
from repro.train import elastic as jelastic
from repro_torch.core import LannsConfig, LannsIndex, brute_force_topk, recall_at_k
from repro_torch.data.synthetic import sift_like
from repro_torch.train import elastic
from repro_torch.train import (
    ShardPlacement,
    StragglerMonitor,
    replan_on_failure,
)


def _same(p, p_r):
    assert dataclasses.asdict(p) == dataclasses.asdict(p_r)


# (hosts, shards, failures in order: each a list of hosts lost together)
EVENTS = [
    (4, 4, [[2], [0]]),
    (4, 4, [[1, 3], [0]]),
    (5, 12, [[4], [1], [0, 2]]),
    (8, 3, [[0], [1], [2], [5, 6]]),
    (3, 16, [[1], [1], [2]]),  # a host reported dead twice
]


@pytest.mark.parametrize("hosts,shards,failures", EVENTS)
def test_placements_match_reference_step_by_step(hosts, shards, failures):
    p = ShardPlacement.initial(hosts, shards)
    p_r = jelastic.ShardPlacement.initial(hosts, shards)
    _same(p, p_r)
    for lost in failures:
        p, p_r = replan_on_failure(p, lost), jelastic.replan_on_failure(p_r, lost)
        _same(p, p_r)
        np.testing.assert_array_equal(p.load(), p_r.load())
        for h in range(hosts):
            assert p.shards_of(h) == p_r.shards_of(h)
        assert all(h not in p.dead for h in p.assignment)
    with pytest.raises(RuntimeError, match="no surviving hosts"):
        replan_on_failure(p, range(hosts))


def test_escalation_plan_matches_reference():
    for data in range(1, 9):
        for model in (1, 2, 4, 8):
            for lost in range(0, data * model + 1):
                got = elastic.escalation_plan(data, model, lost)
                want = jelastic.escalation_plan(data, model, lost)
                assert (got is None) == (want is None)
                if got is not None:
                    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(5)
    mon, mon_r = StragglerMonitor(6, min_samples=3, ratio=1.4), jelastic.StragglerMonitor(
        6, min_samples=3, ratio=1.4)
    placement = ShardPlacement.initial(6, 10)
    placement_r = jelastic.ShardPlacement.initial(6, 10)
    for step in range(12):
        for h in range(6):
            t = float(rng.uniform(0.9, 1.1) * (2.5 if h == 4 and step > 3 else 1.0))
            mon.observe(h, t)
            mon_r.observe(h, t)
        np.testing.assert_array_equal(mon.ewma, mon_r.ewma)
        assert mon.stragglers() == mon_r.stragglers()
        assert mon.speculative_duplicates(placement) == mon_r.speculative_duplicates(placement_r)
    assert mon.stragglers() == [4]


class SearcherFleet:
    """Hosts serve the shards the placement assigns; answers merge at the
    broker exactly as ``LannsIndex.query`` does."""

    def __init__(self, index: LannsIndex, placement: ShardPlacement):
        self.index = index
        self.placement = placement
        self.alive = set(range(placement.num_hosts))

    def kill(self, host: int):
        self.alive.discard(host)
        self.placement = replan_on_failure(self.placement, [host])

    def query(self, qs, topk):
        for s in range(self.index.config.num_shards):  # partial answers otherwise
            assert self.placement.hosts_of(s) in self.alive
        return self.index.query(qs, topk)


def test_fleet_over_saved_port_index_survives_host_loss(tmp_path):
    corpus, queries = sift_like(4000, 32, 64, seed=9)
    cfg = dict(num_shards=4, num_segments=2, segmenter="apd", engine="scan")
    index = LannsIndex(LannsConfig(**cfg), device="cpu").build(corpus)
    index.save(str(tmp_path / "prod"))

    fleet = SearcherFleet(index, ShardPlacement.initial(num_hosts=4, num_shards=4))
    _, i0 = fleet.query(queries, 10)
    _, i_ref = JIndex(JConfig(**cfg)).build(corpus).query(queries, 10)
    np.testing.assert_array_equal(i0, i_ref)

    # host 2 dies: its shard moves; the artifact reloads on the survivors
    fleet.kill(2)
    assert all(h != 2 for h in fleet.placement.assignment)
    fleet.index = LannsIndex.load(str(tmp_path / "prod"), device="cpu")
    assert fleet.index.device.type == "cpu"
    _, i1 = fleet.query(queries, 10)
    np.testing.assert_array_equal(i1, i0)

    # cascade: another host dies; still serving the same answers
    fleet.kill(0)
    assert fleet.placement.generation == 2 and fleet.placement.dead == (0, 2)
    _, i2 = fleet.query(queries, 10)
    np.testing.assert_array_equal(i2, i0)

    _, truth = brute_force_topk(queries, corpus, 10, device="cpu")
    assert recall_at_k(i2, truth, 10) > 0.6
