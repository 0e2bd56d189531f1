"""The port's control layer and block-cyclic path against the JAX package's:
the same numpy data and the same seeded cluster views give the same
values, bytes and Actions."""
import json

import numpy as np
import pytest
import torch

from repro import dmr as jdmr
from repro.dmr.patterns import get_pattern as jget_pattern
from repro_torch import dmr
from repro_torch.core import params as tparams
from repro_torch.core.redistribute import (blockcyclic_merge,
                                           blockcyclic_redistribute,
                                           blockcyclic_split)
from repro_torch.dmr.patterns import get_pattern

BLOCKCYCLIC = [  # (old, new, nblocks, block, width)
    (4, 8, 32, 4, 3), (8, 2, 32, 4, 3), (3, 5, 30, 2, 1), (4, 4, 16, 8, 2),
    (2, 7, 21, 3, 5), (6, 4, 12, 1, 4)]


def _data(nblocks, block, width, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (nblocks * block, width)).astype(np.float32)


@pytest.mark.parametrize("old,new,nblocks,block,width", BLOCKCYCLIC)
def test_blockcyclic_pattern_matches_jax(old, new, nblocks, block, width):
    from repro.core.redistribute import blockcyclic_split as jsplit
    data = _data(nblocks, block, width)
    parts = jsplit(data, old, block)
    ref, jst = jget_pattern(f"blockcyclic:{block}").host_redistribute(
        parts, new)
    out, st = get_pattern(f"blockcyclic:{block}").host_redistribute(
        parts, new)
    assert len(out) == len(ref) == new
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert st.bytes_moved == jst.bytes_moved
    assert st.n_leaves == jst.n_leaves


@pytest.mark.parametrize("old,new,nblocks,block,width", BLOCKCYCLIC)
def test_blockcyclic_on_tensors_matches_numpy(old, new, nblocks, block,
                                              width):
    data = _data(nblocks, block, width, seed=1)
    tparts = blockcyclic_split(torch.from_numpy(data), old, block)
    out = blockcyclic_redistribute(tparts, new, block)
    exp = blockcyclic_split(data, new, block)
    for a, b in zip(out, exp):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(blockcyclic_merge(out, block).numpy(), data)


@pytest.mark.parametrize("old,new", [(4, 8), (8, 2), (6, 3), (3, 6)])
def test_default_and_replicate_patterns_match_jax(old, new):
    data = _data(24, 1, 4, seed=2)
    parts = np.split(data, old)
    for name in ("default", "replicate"):
        ref, jst = jget_pattern(name).host_redistribute(parts, new)
        out, st = get_pattern(name).host_redistribute(parts, new)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        assert st.bytes_moved == jst.bytes_moved


def _views(seed, n=300):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        lo = int(rng.integers(1, 5))
        pref = lo * int(rng.integers(1, 4))
        hi = pref * int(rng.integers(1, 4))
        current = int(rng.choice([lo, pref, hi, max(lo, pref // 2)]))
        pending = [int(x) for x in rng.integers(1, 16, int(rng.integers(0, 3)))]
        yield (current, (lo, hi, pref), int(rng.integers(0, 20)), pending,
               int(rng.integers(0, 6)))


@pytest.mark.parametrize("policy", ["algorithm2", "energy", "throughput"])
def test_policies_match_jax(policy):
    jpol, tpol = jdmr.get_policy(policy), dmr.get_policy(policy)
    for current, (lo, hi, pref), avail, pending, reclaim in _views(7):
        jv = jdmr.ClusterView(avail, pending, reclaim)
        tv = dmr.ClusterView(avail, pending, reclaim)
        ja = jpol.decide(current, jdmr.MalleabilityParams(lo, hi, pref), jv)
        ta = tpol.decide(current, dmr.MalleabilityParams(lo, hi, pref), tv)
        assert (ta.kind, ta.target) == (ja.kind, ja.target), \
            (policy, current, lo, hi, pref, avail, pending, reclaim)


def test_param_helpers_match_jax():
    from repro.core import params as jparams
    for current, (lo, hi, pref), avail, _, floor in _views(8, 100):
        jp, tp = jparams.MalleabilityParams(lo, hi, pref), \
            tparams.MalleabilityParams(lo, hi, pref)
        assert tp.legal_sizes() == jp.legal_sizes()
        assert tp.clamp(avail) == jp.clamp(avail)
        assert tparams.expansion_target(current, tp, avail) == \
            jparams.expansion_target(current, jp, avail)
        assert tparams.shrink_target(current, tp, floor or None) == \
            jparams.shrink_target(current, jp, floor or None)


def test_scripted_and_policy_connectors_match_jax():
    schedule = {3: 8, 4: 2, 9: 4, 12: 1}
    jr, tr = jdmr.connect(dict(schedule)), dmr.connect(dict(schedule))
    jparams, tparams_ = jdmr.MalleabilityParams(1, 8, 4), \
        dmr.MalleabilityParams(1, 8, 4)
    current = 4
    for step in [0, 2, 5, 6, 7, 10, 11, 13, 14]:    # some keys skipped over
        ja = jr.query(step=step, current=current, params=jparams)
        ta = tr.query(step=step, current=current, params=tparams_)
        assert (ta.kind, ta.target) == (ja.kind, ja.target)
        current = ta.target
    views = list(_views(9, 50))
    it_j, it_t = iter(views), iter(views)
    jp = jdmr.PolicyRMS(lambda: jdmr.ClusterView(*next(it_j)[2:5]))
    tp = dmr.PolicyRMS(lambda: dmr.ClusterView(*next(it_t)[2:5]))
    for current, (lo, hi, pref), *_ in views:
        ja = jp.query(step=0, current=current,
                      params=jdmr.MalleabilityParams(lo, hi, pref))
        ta = tp.query(step=0, current=current,
                      params=dmr.MalleabilityParams(lo, hi, pref))
        assert (ta.kind, ta.target) == (ja.kind, ja.target)


def test_file_connector_matches_jax(tmp_path):
    path = tmp_path / "cmd.json"
    jr, tr = jdmr.connect(f"file:{path}"), dmr.connect(f"file:{path}")
    jparams, tparams_ = jdmr.MalleabilityParams(1, 8, 2), \
        dmr.MalleabilityParams(1, 8, 2)
    writes = [None, {"target": 8}, None, "{not json", {"target": 8},
              {"target": 1}, {"target": 64}]
    current = 2
    for w in writes:
        if w is not None:
            path.write_text(w if isinstance(w, str) else json.dumps(w))
        ja = jr.query(step=0, current=current, params=jparams)
        ta = tr.query(step=0, current=current, params=tparams_)
        assert (ta.kind, ta.target) == (ja.kind, ja.target)
        current = ta.target
