"""The JAX package's observability suite (``tests/test_obs.py``) on the
port's ``repro_torch.obs``: each body runs on both packages
(``torch_parity.both``; ``P.om`` is a package's ``obs.metrics``, ``P.ot``
its ``obs.trace``), the reference test's own asserts on each, and the
quantiles, Chrome-trace events and Prometheus exposition text equal."""
import json
import math
import random
import re

import pytest

pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, strategies as st

from torch_parity import both  # noqa: E402


def _exact_pct(samples, q):
    s = sorted(samples)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def _hist(h):
    return {"quantiles": [h.quantile(q) for q in (0.5, 0.9, 0.99)],
            "count": h.count, "sum": h.sum, "min": h.min, "max": h.max,
            "buckets": dict(h._buckets)}


@settings(max_examples=12, deadline=None)
@given(st.integers(0, 10_000))
def test_histogram_quantiles_track_exact_percentiles(seed):
    def body(P):
        om, ot = P.om, P.ot
        rnd = random.Random(seed)
        h = om.Histogram("lat")
        n = rnd.randrange(5, 400)
        samples = [10 ** rnd.uniform(-5, 1) for _ in range(n)]
        for x in samples:
            h.observe(x)
        bound = math.sqrt(h.growth) * (1 + 1e-9)
        for q in (0.5, 0.9, 0.99):
            exact = _exact_pct(samples, q)
            assert exact / bound <= h.quantile(q) <= exact * bound, q
        assert h.count == n
        assert h.min == min(samples) and h.max == max(samples)
        assert h.sum == pytest.approx(sum(samples))
        return _hist(h)
    both(body)


def test_histogram_edge_cases():
    def body(P):
        om, ot = P.om, P.ot
        h = om.Histogram("h")
        empty = h.quantile(0.5)
        assert empty == 0.0
        h.observe(0.0)
        h.observe(-1.0)
        assert h.quantile(0.99) <= h.min_value
        h2 = om.Histogram("h2")
        h2.observe(3.25)
        assert h2.quantile(0.5) == pytest.approx(3.25)
        assert h2.quantile(0.99) == pytest.approx(3.25)
        with pytest.raises(ValueError) as err:
            om.Histogram("bad", growth=1.0)
        return empty, _hist(h), _hist(h2), str(err.value)
    both(body)


def test_histogram_memory_is_bounded_by_buckets_not_samples():
    def body(P):
        om, ot = P.om, P.ot
        h = om.Histogram("h")
        rnd = random.Random(3)
        for _ in range(10_000):
            h.observe(10 ** rnd.uniform(-6, 1))
        assert len(h._buckets) < 150
        assert h.count == 10_000
        return _hist(h)
    both(body)


def test_disabled_tracer_is_a_shared_noop():
    def body(P):
        om, ot = P.om, P.ot
        tr = ot.Tracer()
        assert tr.span("x") is ot.NULL_SPAN
        with tr.span("x") as sp:
            sp.set(a=1)
        tr.instant("y")
        assert tr.events == [] and tr.dropped == 0
        with ot.use(ot.Tracer()):
            assert ot.span("x") is ot.NULL_SPAN
        return tr.chrome_trace()
    both(body)


def test_bypass_short_circuits_even_when_enabled():
    def body(P):
        om, ot = P.om, P.ot
        with ot.bypass() as tr:
            tr.enable()
            assert tr.span("x") is ot.NULL_SPAN
            assert ot.span("x") is ot.NULL_SPAN
            assert tr.events == []
        return tr.chrome_trace()
    both(body)


def test_span_nesting_and_chrome_trace_schema(tmp_path):
    def body(P, name):
        om, ot = P.om, P.ot
        t = [0.0]

        def clock():
            t[0] += 1e-3
            return t[0]

        tr = ot.Tracer(clock=clock)
        tr.enable()
        with ot.use(tr):
            with ot.span("outer", cat="test", depth=0):
                with ot.span("inner", cat="test") as sp:
                    sp.set(depth=1)
                ot.instant("marker", note="hi")
        doc = tr.chrome_trace()
        json.dumps(doc)
        evs = doc["traceEvents"]
        assert [e["name"] for e in evs] == ["inner", "marker", "outer"]
        by_name = {e["name"]: e for e in evs}
        for e in evs:
            assert set(e) >= {"name", "cat", "ph", "ts", "pid", "tid", "args"}
            assert e["ts"] >= 0
        assert by_name["outer"]["ph"] == "X" and by_name["marker"]["ph"] == "i"
        outer, inner = by_name["outer"], by_name["inner"]
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
        assert inner["args"] == {"depth": 1}
        path = tr.export(str(tmp_path / name))
        with open(path) as f:
            text = f.read()
        assert json.loads(text)["traceEvents"] == evs
        return doc, text
    both(body, "trace.json")


def test_tracer_drops_beyond_max_events():
    def body(P):
        om, ot = P.om, P.ot
        tr = ot.Tracer(max_events=3)
        tr.enable()
        for i in range(5):
            tr.instant(f"e{i}")
        assert len(tr.events) == 3 and tr.dropped == 2
        doc = tr.chrome_trace()
        assert doc["otherData"]["dropped_events"] == 2
        tr.clear()
        assert tr.events == [] and tr.dropped == 0
        # the default clock: every field but the times
        return doc["otherData"], [{k: v for k, v in e.items() if k != "ts"}
                                  for e in doc["traceEvents"]]
    both(body)


def test_registry_get_or_create_and_kind_mismatch():
    def body(P):
        om, ot = P.om, P.ot
        reg = om.MetricsRegistry()
        c = reg.counter("reqs", "requests")
        assert reg.counter("reqs") is c
        c.inc()
        c.inc(4)
        reg.gauge("depth").set(7)
        errors = []
        for make in (lambda: reg.gauge("reqs"),
                     lambda: reg.histogram("depth")):
            with pytest.raises(TypeError) as err:
                make()
            errors.append(str(err.value))
        snap = reg.snapshot()
        assert snap["reqs"] == 5 and snap["depth"] == 7
        return snap, errors
    both(body)


def test_snapshot_diff():
    def body(P):
        om, ot = P.om, P.ot
        reg = om.MetricsRegistry()
        reg.counter("c").inc(10)
        h = reg.histogram("h")
        h.observe(1.0)
        s0 = reg.snapshot()
        reg.counter("c").inc(5)
        h.observe(2.0)
        h.observe(4.0)
        d = om.diff_snapshots(reg.snapshot(), s0)
        assert d["c"] == 5
        assert d["h"]["count"] == 2 and d["h"]["sum"] == pytest.approx(6.0)
        return d, reg.snapshot()
    both(body)


_PROM_LINE = re.compile(
    r'^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+'
    r'|[a-zA-Z_:][a-zA-Z0-9_:]*(\{quantile="[0-9.]+"\})? -?[0-9][0-9a-z.+-]*)$')


def test_prometheus_exposition_parses():
    """Every line parses, and the port's exposition text equals the
    reference's, byte for byte."""
    def body(P):
        om, ot = P.om, P.ot
        reg = om.MetricsRegistry()
        reg.counter("rpq_submitted_total", "total submissions").inc(3)
        reg.gauge("rpq_in_flight", "slots busy").set(2)
        h = reg.histogram("rpq_e2e_seconds", "end to end")
        for v in (0.001, 0.002, 0.004):
            h.observe(v)
        reg.counter("weird-name.with chars").inc()
        text = reg.to_prometheus()
        assert text.endswith("\n")
        for line in text.splitlines():
            assert _PROM_LINE.match(line), line
        assert "rpq_e2e_seconds_count 3" in text
        assert 'rpq_e2e_seconds{quantile="0.5"}' in text
        assert "weird_name_with_chars 1" in text
        return text
    both(body)
