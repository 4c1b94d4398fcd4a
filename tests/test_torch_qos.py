"""The port's QoS declarations (``nvshare_tpu_torch.qos``) against the
JAX package's on the same inputs: the spec grammar, the REGISTER caps
encoding, the environment default, the entitled shares, the report's
trace replay, and what the real scheduler sees of a port tenant and a
reference tenant that declare the same spec. All exact (no tolerance):
the values are integers, strings and shares computed the same way.
"""

import json

import pytest

from nvshare_tpu.qos import report as ref_report
from nvshare_tpu.qos import spec as ref_spec
from nvshare_tpu_torch.qos import report as port_report
from nvshare_tpu_torch.qos import spec as port_spec

SPECS = ["interactive:2", "batch:1", "interactive", "batch", "batch:255",
         "interactive:1", "", None,
         "gold:2", "interactive:banana", "interactive:0", "interactive:256",
         "batch:-1", "Batch:1", "batch:1.5", ":2"]


def _parse(mod, text):
    try:
        s = mod.parse_qos(text)
    except ValueError:
        return "ValueError"
    return None if s is None else (s.klass, s.weight, str(s), s.to_caps(),
                                   s.interactive, s.class_name)


@pytest.mark.parametrize("text", SPECS)
def test_spec_grammar_matches_reference(text):
    assert _parse(port_spec, text) == _parse(ref_spec, text)


@pytest.mark.parametrize("caps", [0, 1, 8, 8 | (1 << 8) | (2 << 16),
                                  8 | (2 << 16), 8 | (7 << 8) | (9 << 16),
                                  1 | 8 | (255 << 16), 4 | 32])
def test_caps_decode_matches_reference(caps):
    got = port_spec.QosSpec.from_caps(caps)
    want = ref_spec.QosSpec.from_caps(caps)
    assert (None if got is None else (got.klass, got.weight)) == \
        (None if want is None else (want.klass, want.weight))


@pytest.mark.parametrize("value", ["interactive:3", "platinum:99", "",
                                   "batch:0"])
def test_env_default_matches_reference(monkeypatch, value):
    monkeypatch.setenv("TPUSHARE_QOS", value)
    got, want = port_spec.from_env(), ref_spec.from_env()
    assert (None if got is None else (got.klass, got.weight)) == \
        (None if want is None else (want.klass, want.weight))


@pytest.mark.parametrize("weights", [{"a": 2, "b": None, "c": 1},
                                     {"inter": 2, "batch": 1}, {},
                                     {"x": 0, "y": "3", "z": 255}])
def test_entitled_shares_match_reference(weights):
    assert port_spec.entitled_shares(weights) == \
        ref_spec.entitled_shares(weights)


def _synthetic_trace():
    """Three tenants with spans and gate waits, one undeclared."""
    meta = [{"ph": "M", "pid": 1, "tid": t, "name": "thread_name",
             "args": {"name": n}}
            for t, n in ((1, "a"), (2, "b"), (3, "c"), (4, "scheduler"),
                         (5, "handoffs"))]
    spans = [{"ph": "X", "ts": ts, "dur": dur, "pid": 1, "tid": tid,
              "name": "device-lock", "args": {}}
             for ts, dur, tid in ((0, 2000, 1), (2100, 1000, 2),
                                  (3200, 2000, 1), (5300, 1000, 2),
                                  (6400, 700, 3))]
    waits = [{"ph": "i", "s": "t", "ts": ts, "pid": 1, "tid": tid,
              "name": "GATE_WAIT", "args": {"seconds": s}}
             for ts, tid, s in ((2050, 1, 0.5), (3100, 2, 2.0),
                                (5200, 2, 3.0), (6300, 3, "1.25"),
                                (6350, 1, 0.125))]
    return {"traceEvents": meta + spans + waits}


def test_report_matches_reference():
    trace = _synthetic_trace()
    for specs in ({"a": "interactive:2", "b": "batch:1"}, {}):
        got = port_report.build_report(
            trace, {n: port_spec.parse_qos(s) for n, s in specs.items()})
        want = ref_report.build_report(
            trace, {n: ref_spec.parse_qos(s) for n, s in specs.items()})
        assert got == want
        assert port_report.render_text(got) == ref_report.render_text(want)


def test_report_cli_matches_reference(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_synthetic_trace()))
    args = [str(path), "--spec", "a=interactive:2", "--spec", "b=batch:1",
            "--json"]
    assert port_report.main(args) == 0
    got = capsys.readouterr().out
    assert ref_report.main(args) == 0
    assert got == capsys.readouterr().out


def test_register_caps_seen_in_fairness_rows(sched, monkeypatch):
    """A port tenant and a reference tenant declaring the same spec send
    the same REGISTER caps: the scheduler's fairness rows carry the same
    validated ``qos=``/``qw=`` labels, and the specs read back from them
    agree. A port ``Tenant(qos=)`` exposes its spec as ``tenant.qos``."""
    from nvshare_tpu.runtime.client import PurePythonClient as RefClient
    from nvshare_tpu.telemetry.dump import fetch_sched_stats as ref_fetch
    from nvshare_tpu_torch.colocate import Tenant
    from nvshare_tpu_torch.runtime.client import PurePythonClient
    from nvshare_tpu_torch.telemetry.dump import fetch_sched_stats

    monkeypatch.setenv("TPUSHARE_SOCK_DIR", sched.sock_dir)
    monkeypatch.setenv("TPUSHARE_QOS", "batch:4")
    clients = [PurePythonClient(job_name="port-dec", qos="interactive:3"),
               RefClient(job_name="ref-dec", qos="interactive:3"),
               PurePythonClient(job_name="port-env"),
               RefClient(job_name="ref-env")]
    monkeypatch.delenv("TPUSHARE_QOS")
    clients += [PurePythonClient(job_name="port-none"),
                RefClient(job_name="ref-none")]
    tenant = Tenant("port-tenant", device="cpu", qos="batch:2")
    try:
        assert tenant.qos == port_spec.parse_qos("batch:2")
        assert clients[0].qos.to_caps() == clients[1].qos.to_caps()
        st = fetch_sched_stats(path=sched.path)
        ref_st = ref_fetch(path=sched.path)
        assert [r["client"] for r in st["clients"]] == \
            [r["client"] for r in ref_st["clients"]]
        rows = {r["client"]: r for r in st["clients"]}
        for port, ref in (("port-dec", "ref-dec"), ("port-env", "ref-env"),
                          ("port-none", "ref-none")):
            assert (rows[port].get("qos"), rows[port].get("qw")) == \
                (rows[ref].get("qos"), rows[ref].get("qw"))
        assert (rows["port-dec"]["qos"], rows["port-dec"]["qw"]) == \
            ("int", 3)
        assert (rows["port-env"]["qos"], rows["port-env"]["qw"]) == \
            ("bat", 4)
        assert "qos" not in rows["port-none"]
        assert (rows["port-tenant"]["qos"], rows["port-tenant"]["qw"]) == \
            ("bat", 2)
        assert st["summary"]["qpol"] == "wfq"
        got = port_report.specs_from_stats(st)
        want = ref_report.specs_from_stats(st)
        assert {n: (s.klass, s.weight) if s else None
                for n, s in got.items()} == \
            {n: (s.klass, s.weight) if s else None
             for n, s in want.items()}
    finally:
        tenant.close()
        for c in clients:
            c.shutdown()
