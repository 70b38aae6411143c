"""The port's engine fleet against the reference's, live, on the paths
that move sessions between workers: prefill/decode roles (2P+2D), fault
injection with crash recovery, scheduled decode-to-decode migration, and
ordered streams in fleet mode.  The workload and the comparison are
``test_torch_fleet``'s: qwen2-0.5b's smoke config at fp32 on the CPU,
the first burst of the canonical trace, every token and every
``FleetReport`` field equal to the reference's (the metrics export but
for the compile-count series).

* ``roles="2P+2D"``: every request prefills on a prefill worker and its
  KV lands on a decode worker; the tokens also equal the co-located
  fleet's.
* ``canonical_crash_plan()`` on ``canonical_faulted_trace()[:24]`` (the
  crash lands at 4.5 ms, after the burst: an idle worker dies), and
  ``crash@0.6ms:w0`` with a 600 us deadline, which kills worker 0 holding
  live sessions: their prompt plus emitted prefix re-prefills on a
  survivor, and the spliced streams equal the fault-free run's.  Shed,
  failed, recovered and the detection latencies equal the reference's.
* a scheduled migration w1 -> w2 mid-decode: the same tokens as the
  unmigrated fleet.
* streams: 6 ordered lanes with session-affinity placement; each lane's
  requests complete in order on one channel group.
"""

import pytest

from repro_torch.serve.fabric import EngineWorker
from tests.test_torch_fleet import (DIAG4, SERVED, assert_reports_equal,
                                    connect, prompt_of, reference, serve,
                                    trace)

DIAG2 = (2, 2, 2, 1)


@pytest.mark.parametrize("k", [1, 8])
def test_disaggregated_fleet_matches_reference(k):
    kw = dict(roles="2P+2D")
    expect, j_client = reference(DIAG2, k, **kw)
    got, t_client = serve("port", DIAG2, k, **kw)
    assert got == expect
    assert got == reference(DIAG2, k)[0]            # = co-located
    rep = t_client.report
    assert rep.roles == (2, 2) and rep.handoffs == 24
    assert {c.worker for c in rep.completions} <= {2, 3}
    assert rep.kv_bytes_moved == j_client.report.kv_bytes_moved > 0
    assert_reports_equal(rep, j_client.report)


#: crash@4.5ms:w0 is ``canonical_crash_plan()``
CRASHES = {
    "canonical": dict(faults="crash@4.5ms:w0"),
    "mid_decode": dict(faults="crash@0.6ms:w0",
                       recovery=(("deadline_ns", 600_000.0),)),
}


@pytest.mark.parametrize("name", sorted(CRASHES))
def test_crash_recovery_matches_reference(name, monkeypatch):
    kw = CRASHES[name]
    expect, j_client = reference(DIAG2, 8, trace_name="faulted", **kw)
    prefixes = []
    retry = EngineWorker.admit_retry

    def recorded(self, arrival, orig, prefix, t_ns):
        prefixes.append(len(prefix or ()))
        return retry(self, arrival, orig, prefix, t_ns)

    monkeypatch.setattr(EngineWorker, "admit_retry", recorded)
    got, t_client = serve("port", DIAG2, 8, trace_name="faulted", **kw)
    assert got == expect
    assert got == reference(DIAG2, 8, trace_name="faulted")[0]
    rep, j_rep = t_client.report, j_client.report
    assert rep.faults_injected == 1 and rep.duplicate_completions == 0
    assert t_client.dedup_conflicts == j_client.dedup_conflicts == 0
    assert t_client.shed == j_client.shed
    assert t_client.failed == j_client.failed
    assert_reports_equal(rep, j_rep)
    if name == "mid_decode":
        # worker 0 died holding live sessions: each re-prefilled its
        # prompt + emitted prefix on a survivor
        assert rep.detections == 1 and rep.recovered and not rep.failed
        assert len(prefixes) == rep.retries == len(rep.recovered)
        assert max(prefixes) > 0


def test_migration_matches_reference():
    kw = dict(migrations=((120_000.0, 1, 2),))
    expect, j_client = reference(DIAG4, 8, **kw)
    got, t_client = serve("port", DIAG4, 8, **kw)
    assert got == expect == reference(DIAG4, 8)[0]
    rep = t_client.report
    assert rep.migrations == 1 and rep.handoffs > 0
    assert_reports_equal(rep, j_client.report)


def _streams(side):
    """6 ordered lanes of 4 requests each (lane i takes every 6th of the
    trace's 24), session-affinity placement."""
    client = connect(side, "qwen2-0.5b", DIAG2, n_workers=4, n_slots=4,
                     max_len=64, decode_horizon=8,
                     placement="session_affinity")
    vocab = SERVED["qwen2-0.5b"]()[0].vocab
    lanes = [client.stream() for _ in range(6)]
    for i, a in enumerate(trace()):
        lanes[i % 6].submit(prompt_of(vocab, a),
                            max_new_tokens=a.max_new_tokens, at_ns=a.t_ns)
    return client.run(), client, lanes


def test_streams_in_fleet_mode_match_reference():
    got, t_client, t_lanes = _streams("port")
    expect, j_client, _ = _streams("repro")
    assert got == expect
    assert_reports_equal(t_client.report, j_client.report)
    done = {c.rid: c for c in t_client.report.completions}
    for lane in t_lanes:
        times = [done[r].t_done_ns for r in lane.rids]
        assert times == sorted(times) and len(set(times)) == len(times)
        # diag2 at 4 workers: channel q is drained by workers 2q, 2q+1;
        # a lane's session key pins it to one channel
        assert len({done[r].worker // 2 for r in lane.rids}) == 1, lane
        assert lane.outputs == [got[r] for r in lane.rids]
