"""The port's launcher serves a fleet on the CPU (``--device cpu``): bursty
traffic over 4 workers, prefill/decode roles, a fault plan with
recovery, a scheduled migration and live re-planning, each with
``--trace-out`` / ``--metrics-out``.  Every run serves all its requests,
prints the fleet report's lines, and writes a trace that the port's
``validate_trace`` (and the reference's) accepts.  The launcher's fleet
checks refuse what the reference's refuse."""

import json

import pytest

from repro.obs import validate_trace as j_validate
from repro_torch.launch import serve as launcher
from repro_torch.obs import validate_trace

BASE = ["--smoke", "--device", "cpu", "--max-len", "64", "--prompt-len",
        "8", "--max-new", "6", "--decode-horizon", "4", "--slots", "2"]

RUNS = {
    "bursty": (["--workers", "4", "--traffic", "bursty", "--requests",
                "12"], ["fleet: 4 workers, vector s1c1e4"]),
    "roles": (["--workers", "4", "--roles", "2P+2D", "--requests", "8",
               "--plan", "shared_dynamic", "--mixed-lengths"],
              ["disagg: 2P+2D, 8 KV handoffs"]),
    "faults": (["--workers", "4", "--plan", "shared_dynamic", "--faults",
                "crash@0.1ms:w0", "--deadline-us", "600", "--requests",
                "16", "--traffic", "bursty"],
               ["chaos: 1 faults, 1 detections", "0 duplicate"]),
    "migrate": (["--workers", "4", "--migrate", "60us:w1:w2",
                 "--requests", "12", "--placement", "least_loaded"],
                ["1 live migrations"]),
    "adaptive": (["--workers", "4", "--plan", "shared_dynamic",
                  "--adaptive", "--adapt-window", "100", "--traffic",
                  "phased", "--requests", "12"],
                 ["adaptive: ", " windows, "]),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_launcher_serves_a_fleet_and_traces_it(name, tmp_path, capsys):
    flags, expect = RUNS[name]
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    launcher.main(BASE + flags + ["--trace-out", str(trace),
                                  "--metrics-out", str(metrics)])
    out = capsys.readouterr().out
    n = int(flags[flags.index("--requests") + 1])
    if name == "adaptive":
        n = 3 * (n // 3)          # phased: n // 3 requests per busy phase
    assert f"{n}/{n} requests" in out, out
    assert "executor=fleet" in out
    for line in expect:
        assert line in out, (line, out)
    doc = json.loads(trace.read_text())
    assert validate_trace(doc) == [] == j_validate(doc)
    assert sum(e["ph"] == "b" and e["name"] == "request"
               for e in doc["traceEvents"]) == n
    reg = json.loads(metrics.read_text())
    assert reg["metrics"]["fleet.completed"][0]["value"] == n


@pytest.mark.parametrize("flags,words", [
    (["--workers", "1", "--engine", "continuous", "--faults",
      "crash@1ms:w0"], "need a fleet"),
    (["--workers", "1", "--engine", "continuous", "--roles", "1P+1D"],
     "need a fleet"),
    (["--workers", "4", "--engine", "wave"], "continuous-engine workers"),
    (["--engine", "wave", "--adaptive"], "cannot re-plan live"),
    (["--workers", "4", "--prompt-len", "60"], "must fit max-len"),
    (["--workers", "4", "--migrate", "1ms:1:2"], "TIME:wSRC:wDST"),
    (["--plan", "dynamic", "--category", "static"], "conflicts with"),
])
def test_launcher_refuses_what_the_reference_refuses(flags, words, capsys):
    with pytest.raises(SystemExit):
        launcher.main(BASE + flags)
    assert words in capsys.readouterr().err
