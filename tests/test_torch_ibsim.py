"""The port's copy of the paper's InfiniBand data-path simulator
(``repro_torch.core.ibsim``) and of the sweep builders of
``core/endpoints.py`` against the reference's, live.

The simulator is host code in virtual time, so every number is held to
exact equality: the endpoint models the builders make (paths and
resource usage), the cost model's derived quantities, each simulated
thread's completion time, ``message_rate`` for every category at 16
threads under ``ALL_FEATURES`` and ``CONSERVATIVE``, and
``category_table``'s normalised rates, on ``test_ibsim_calibration``'s
inputs (2048 messages a thread) and on each Fig. 7 / 9 / 11 sweep.
"""

import dataclasses

import pytest

import repro.core as jcore
import repro.core.ibsim as jibsim
import repro_torch.core as tcore
import repro_torch.core.ibsim as tibsim
from repro.core.ibsim.costmodel import (BufferConfig as JBuffers,
                                        CostModel as JCost)
from repro.core.resources import naive_td_per_ctx_usage as j_naive
from repro_torch.core.ibsim.costmodel import (BufferConfig as TBuffers,
                                              CostModel as TCost)
from repro_torch.core.resources import naive_td_per_ctx_usage as t_naive

MSGS = 2048
FEATURES = ("ALL_FEATURES", "CONSERVATIVE")


def _features(pkg, name, without=None):
    f = getattr(pkg.costmodel, name)
    return f.without(without) if without else f


def _model_tuple(m):
    return (m.category and m.category.value, m.n_threads, m.label,
            [dataclasses.astuple(p) for p in m.paths],
            dataclasses.astuple(m.usage))


def _rate_tuple(r):
    return (r.label, r.rate_mmps, r.makespan_ns, r.total_msgs,
            dataclasses.astuple(r.features), r.usage, r.csv_row())


def test_exports_match_the_reference():
    assert sorted(tibsim.__all__) == sorted(
        set(jibsim.__all__) | {"Resource", "ALL_FEATURES", "CONSERVATIVE",
                               "category_rate", "category_table"})
    assert sorted(tcore.__all__) == sorted(jcore.__all__)


@pytest.mark.parametrize("features", FEATURES)
def test_message_rate_of_every_category_equals_the_reference(features):
    for cat in jcore.Category:
        tcat = tcore.Category(cat.value)
        j = jibsim.message_rate(jcore.EndpointModel.build(cat, 16),
                                features=_features(jibsim, features),
                                msgs_per_thread=MSGS)
        t = tibsim.message_rate(tcore.EndpointModel.build(tcat, 16),
                                features=_features(tibsim, features),
                                msgs_per_thread=MSGS)
        assert _rate_tuple(t) == _rate_tuple(j), cat


@pytest.mark.parametrize("features", FEATURES)
def test_category_table_equals_the_reference(features):
    from repro.core.ibsim.benchmark import category_table as j_table
    from repro_torch.core.ibsim.benchmark import category_table as t_table
    j = j_table(16, features=_features(jibsim, features),
                msgs_per_thread=MSGS)
    t = t_table(16, features=_features(tibsim, features),
                msgs_per_thread=MSGS)
    assert [c.value for c in t] == [c.value for c in j]
    for tc, jc in zip(t, j):
        assert t[tc]["vs_everywhere"] == j[jc]["vs_everywhere"]
        assert _rate_tuple(t[tc]["result"]) == _rate_tuple(j[jc]["result"])


#: (builder, args, kwargs, feature ablation): test_ibsim_calibration's
#: sweeps (Figs. 7, 9/10 and 11)
SWEEPS = [
    ("build_ctx_shared", (16, 1), {}, None),
    ("build_ctx_shared", (16, 8), {}, "postlist"),
    ("build_ctx_shared", (16, 16), {}, "postlist"),
    ("build_ctx_shared", (16, 16), {"two_x": True}, "postlist"),
    ("build_ctx_shared", (16, 4), {"cq_share_ways": 4}, None),
    ("build_cq_shared", (16, 1), {}, "unsignaled"),
    ("build_cq_shared", (16, 16), {}, "unsignaled"),
    ("build_qp_shared", (16, 1), {}, None),
    ("build_qp_shared", (16, 2), {}, None),
    ("build_qp_shared", (16, 4), {}, None),
    ("build_qp_shared", (16, 8), {}, None),
    ("build_qp_shared", (16, 16), {}, None),
]


@pytest.mark.parametrize("builder,args,kw,without", SWEEPS,
                         ids=[f"{b}-{a[1]}-{'-'.join(kw) or 'plain'}-"
                              f"{w or 'all'}" for b, a, kw, w in SWEEPS])
def test_sweep_builders_and_their_rates_equal_the_reference(
        builder, args, kw, without):
    jm = getattr(jcore, builder, None) or getattr(
        jcore.endpoints, builder)
    tm = getattr(tcore, builder, None) or getattr(
        tcore.endpoints, builder)
    j_model, t_model = jm(*args, **kw), tm(*args, **kw)
    assert _model_tuple(t_model) == _model_tuple(j_model)
    j = jibsim.message_rate(j_model, features=_features(
        jibsim, "ALL_FEATURES", without), msgs_per_thread=MSGS)
    t = tibsim.message_rate(t_model, features=_features(
        tibsim, "ALL_FEATURES", without), msgs_per_thread=MSGS)
    assert _rate_tuple(t) == _rate_tuple(j)


def test_hybrid_split_equals_the_reference():
    from repro.core.endpoints import build_hybrid as j_hybrid
    from repro_torch.core.endpoints import build_hybrid as t_hybrid
    for cat in jcore.Category:
        j = j_hybrid(4, 4, cat)
        t = t_hybrid(4, 4, tcore.Category(cat.value))
        assert _model_tuple(t) == _model_tuple(j), cat


def test_simulator_threads_finish_when_the_reference_s_do():
    """Per-thread completion times, and the simulator under a shared,
    unaligned buffer layout and a costlier NIC."""
    cost_kw = {"t_nic_wqe": 9.0, "t_lock_contended": 140.0}
    for bufs in ("aligned", "shared", "unaligned"):
        args = {"aligned": (16,), "shared": (16, 4),
                "unaligned": (16, 2)}[bufs]
        for cat in jcore.Category:
            j = jibsim.Simulator(
                jcore.EndpointModel.build(cat, 16),
                cost=JCost(**cost_kw), buffers=getattr(JBuffers, bufs)(
                    *args), msgs_per_thread=256).run()
            t = tibsim.Simulator(
                tcore.EndpointModel.build(tcore.Category(cat.value), 16),
                cost=TCost(**cost_kw), buffers=getattr(TBuffers, bufs)(
                    *args), msgs_per_thread=256).run()
            assert dataclasses.astuple(t) == dataclasses.astuple(j)
            assert t.rate_mmps == j.rate_mmps


def test_cost_model_and_naive_usage_equal_the_reference():
    j, t = JCost(), TCost()
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    for size in (2, 60, 64, 100, 4096):
        for inline in (False, True):
            assert t.wqe_bytes(size, inline) == j.wqe_bytes(size, inline)
    for n in (1, 4, 16):
        assert dataclasses.astuple(t_naive(n)) == \
            dataclasses.astuple(j_naive(n))
        assert t_naive(n).waste_fraction == j_naive(n).waste_fraction
