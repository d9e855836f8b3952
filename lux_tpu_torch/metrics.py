"""Streaming serving metrics: counters, gauges and mergeable
log-linear histograms (counterpart of lux_tpu/metrics.py:68-480, pure
host Python; the port keeps its own copy).

- ``Counter`` / ``Gauge``: monotone totals and last-value samples.
- ``Histogram``: an HDR-style log-linear histogram — values bucket by
  (power-of-two octave, ``HIST_SUB`` linear sub-buckets per octave),
  so memory is fixed (at most ``HIST_BUCKETS`` sparse cells a series)
  and a quantile read (the containing bucket's midpoint) is within
  ``QUANTILE_REL_ERR`` = 1/HIST_SUB of the true value.  Histograms
  merge bucket-wise, losslessly.
- ``Registry``: the label-aware, thread-safe series store, with
  ``snapshot()`` (a JSON-ready dict), ``emit_snapshot()`` (a
  ``metrics_snapshot`` event on the active telemetry handle) and
  ``prometheus_text()`` (the Prometheus text exposition, cumulative
  ``le`` buckets), served by ``python -m lux_tpu_torch.metrics -serve
  PORT`` over the standard library's http.server.

The serving layer (serve.py) feeds them on the host at segment
boundaries only, never inside device code.
"""

from __future__ import annotations

import math
import threading

SCHEMA = 1

# Log-linear histogram geometry (PINNED: merging and the error bound
# are only meaningful between identically-bucketed series).
HIST_SUB = 32                 # linear sub-buckets per power-of-two octave
HIST_EXP_MIN = -27            # lowest octave lower edge = 2**-27 (~7.5 ns)
HIST_EXP_MAX = 21             # highest octave upper edge = 2**21 (~24 days)
HIST_BUCKETS = (HIST_EXP_MAX - HIST_EXP_MIN) * HIST_SUB
# A quantile read returns the containing bucket's midpoint; the bucket
# width is lo/HIST_SUB, so |read - true| <= lo/(2*HIST_SUB) <=
# true/(2*HIST_SUB).  1/HIST_SUB is the published (doubled, safe)
# bound — pinned against a NumPy oracle in tests/test_torch_metrics.py.
QUANTILE_REL_ERR = 1.0 / HIST_SUB

SNAPSHOT_QUANTILES = (0.5, 0.9, 0.99)


def bucket_index(v: float) -> int:
    """Bucket of a positive finite value (values at/under the range
    floor clamp to bucket 0, past the ceiling to the last bucket —
    the error bound holds only inside the range, which spans ~7.5 ns
    to ~24 days and covers any latency a serving tier can observe)."""
    if not v > 0.0 or v != v or v == float("inf"):
        return 0
    m, e = math.frexp(v)            # v = m * 2**e, m in [0.5, 1)
    octave = e - 1                  # v in [2**octave, 2**(octave+1))
    if octave < HIST_EXP_MIN:
        return 0
    if octave >= HIST_EXP_MAX:
        return HIST_BUCKETS - 1
    j = int((2.0 * m - 1.0) * HIST_SUB)     # linear within the octave
    j = min(max(j, 0), HIST_SUB - 1)
    return (octave - HIST_EXP_MIN) * HIST_SUB + j


def bucket_lo(idx: int) -> float:
    octave = HIST_EXP_MIN + idx // HIST_SUB
    j = idx % HIST_SUB
    return math.ldexp(1.0 + j / HIST_SUB, octave)


def bucket_hi(idx: int) -> float:
    octave = HIST_EXP_MIN + idx // HIST_SUB
    j = idx % HIST_SUB
    return math.ldexp(1.0 + (j + 1) / HIST_SUB, octave)


def bucket_mid(idx: int) -> float:
    return 0.5 * (bucket_lo(idx) + bucket_hi(idx))


class Counter:
    """Monotone total.  ``inc`` rejects negative deltas — a counter
    that can go down is a gauge, and mixing the two breaks burn-rate
    arithmetic silently.  Updates are lock-protected: series are fed
    from submitter threads concurrently with the drain thread, and
    an unlocked read-modify-write would lose increments at a GIL
    switch."""

    kind = "counter"

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self.value += n


class Gauge:
    """Last-value sample (queue depth, occupancy, burn rate)."""

    kind = "gauge"

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        # lockcheck: allow(guarded-field) last-value store is ONE
        # GIL-atomic assignment; set_max/inc/dec lock because they
        # read-modify-write
        self.value = float(v)

    def set_max(self, v: float) -> None:
        """Ratchet: keep the LARGEST value ever set — the watermark
        idiom (peak resident bytes).  Lock-protected like inc/dec: two boundary threads racing a
        plain read-compare-set could regress the peak."""
        v = float(v)
        with self._lock:
            if v > self.value:
                self.value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self.value -= n


class Histogram:
    """Mergeable log-linear histogram (see module docstring for the
    geometry and the pinned error bound).  Memory: a sparse dict of
    at most HIST_BUCKETS cells plus four exact scalars — O(1) in the
    observation count."""

    kind = "histogram"

    def __init__(self):
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        idx = bucket_index(v)
        with self._lock:
            self.buckets[idx] = self.buckets.get(idx, 0) + 1
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def _state(self):
        """Consistent (buckets copy, count, sum, min, max) — reads
        must not race a concurrent observe mid-update."""
        with self._lock:
            return (dict(self.buckets), self.count, self.sum,
                    self.min, self.max)

    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile -> the containing bucket's midpoint
        (relative error <= QUANTILE_REL_ERR inside the bucket range).
        None on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        buckets, count, _sum, _mn, _mx = self._state()
        if count == 0:
            return None
        rank = max(1, math.ceil(q * count))
        seen = 0
        for idx in sorted(buckets):
            seen += buckets[idx]
            if seen >= rank:
                return bucket_mid(idx)
        return bucket_mid(max(buckets))         # unreachable guard

    def mean(self) -> float | None:
        """Exact mean (sum/count — the scalars are exact even though
        the buckets quantize); None on an empty histogram."""
        with self._lock:
            return self.sum / self.count if self.count else None

    def merge(self, other: "Histogram") -> "Histogram":
        """Bucket-wise sum — associative and commutative (proven by
        test), the multi-series / multi-replica combine."""
        out = Histogram()
        mins, maxs = [], []
        for src in (self, other):
            buckets, count, s, mn, mx = src._state()
            for idx, n in buckets.items():
                out.buckets[idx] = out.buckets.get(idx, 0) + n
            out.count += count
            out.sum += s
            if mn is not None:
                mins.append(mn)
            if mx is not None:
                maxs.append(mx)
        out.min = min(mins) if mins else None
        out.max = max(maxs) if maxs else None
        return out

    def snapshot_entry(self) -> dict:
        """The JSON-ready body of one histogram series in a
        metrics_snapshot event: exact count/sum/min/max, the standard
        quantiles, and the sparse bucket cells (str keys — JSON
        objects key on strings) so readers can re-merge and
        events_summary can cross-audit count == sum(buckets)."""
        buckets, count, s, mn, mx = self._state()
        out = {"count": count, "sum": round(s, 9),
               "min": mn, "max": mx,
               "buckets": {str(i): n
                           for i, n in sorted(buckets.items())}}
        for q in SNAPSHOT_QUANTILES:
            if count == 0:
                out[f"p{int(q * 100)}"] = None
                continue
            rank = max(1, math.ceil(q * count))
            seen = 0
            for idx in sorted(buckets):
                seen += buckets[idx]
                if seen >= rank:
                    out[f"p{int(q * 100)}"] = round(bucket_mid(idx),
                                                    9)
                    break
        return out

    @classmethod
    def from_snapshot(cls, entry: dict) -> "Histogram":
        """Rebuild a mergeable histogram from a snapshot entry (the
        loadgen path: read snapshots back, merge per-kind series)."""
        h = cls()
        h.buckets = {int(k): int(n)
                     for k, n in (entry.get("buckets") or {}).items()}
        h.count = int(entry.get("count", sum(h.buckets.values())))
        h.sum = float(entry.get("sum") or 0.0)
        h.min = entry.get("min")
        h.max = entry.get("max")
        return h


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Registry:
    """Label-aware series store.  get-or-create is thread-safe; a
    name re-registered as a different series type is a hard error
    (silent type punning would corrupt every consumer)."""

    def __init__(self):
        self._series: dict[tuple, object] = {}
        self._types: dict[str, str] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str, labels: dict):
        key = (name, _label_key(labels))
        with self._lock:
            prev = self._types.get(name)
            if prev is not None and prev != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {prev}, "
                    f"cannot re-register as {kind}")
            self._types[name] = kind
            s = self._series.get(key)
            if s is None:
                s = _KINDS[kind]()
                self._series[key] = s
            return s

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    def series(self):
        """[(name, labels dict, series object)] in sorted order."""
        with self._lock:
            items = sorted(self._series.items())
        return [(name, dict(lk), s) for (name, lk), s in items]

    # -- exposure ------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready snapshot: the body of a ``metrics_snapshot``
        telemetry event (schema + one list per series type)."""
        counters, gauges, hists = [], [], []
        for name, labels, s in self.series():
            if s.kind == "counter":
                counters.append({"name": name, "labels": labels,
                                 "value": s.value})
            elif s.kind == "gauge":
                gauges.append({"name": name, "labels": labels,
                               "value": s.value})
            else:
                hists.append({"name": name, "labels": labels,
                              **s.snapshot_entry()})
        return {"schema": SCHEMA, "counters": counters,
                "gauges": gauges, "histograms": hists}

    def emit_snapshot(self, **extra) -> dict | None:
        """Publish the snapshot as a ``metrics_snapshot`` event on
        the ACTIVE telemetry handle (no-op on the null handle) —
        periodic snapshots riding the EventLog are how a load harness
        or a postmortem reads the serving tier back."""
        from lux_tpu_torch import telemetry
        return telemetry.current().emit("metrics_snapshot",
                                        **self.snapshot(), **extra)

    def prometheus_text(self) -> str:
        """Prometheus text exposition (0.0.4): counters and gauges as
        plain samples, histograms as CUMULATIVE ``le`` buckets
        (non-empty cells + ``+Inf``) with ``_sum``/``_count`` —
        scrapeable by any Prometheus-compatible collector."""
        by_name: dict[str, list] = {}
        for name, labels, s in self.series():
            by_name.setdefault(name, []).append((labels, s))
        lines = []
        for name in sorted(by_name):
            entries = by_name[name]
            lines.append(f"# TYPE {name} {entries[0][1].kind}")
            for labels, s in entries:
                if s.kind in ("counter", "gauge"):
                    lines.append(f"{name}{_fmt_labels(labels)} "
                                 f"{_fmt_num(s.value)}")
                    continue
                buckets, count, total, _mn, _mx = s._state()
                cum = 0
                for idx in sorted(buckets):
                    cum += buckets[idx]
                    le = dict(labels, le=_fmt_num(bucket_hi(idx)))
                    lines.append(f"{name}_bucket{_fmt_labels(le)} "
                                 f"{cum}")
                inf = dict(labels, le="+Inf")
                lines.append(f"{name}_bucket{_fmt_labels(inf)} "
                             f"{count}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_num(total)}")
                lines.append(f"{name}_count{_fmt_labels(labels)} "
                             f"{count}")
        return "\n".join(lines) + "\n"


def _fmt_num(v: float) -> str:
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"") \
            .replace("\n", r"\n")


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{_escape(str(v))}"'
                    for k, v in sorted(labels.items()))
    return "{" + body + "}"


_DEFAULT = Registry()


def default_registry() -> Registry:
    """The process-default registry (what ``-serve`` exposes)."""
    return _DEFAULT


# ---------------------------------------------------------------------
# stdlib-http exposition endpoint

def serve_http(registry: Registry, port: int, host: str = "127.0.0.1"):
    """Build (not start) an HTTP server exposing ``/metrics`` as
    Prometheus text — stdlib ``http.server`` only, by contract.
    Returns the server; call ``serve_forever()`` (the CLI does) or
    drive it from a thread (the tests do, with port 0)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):            # noqa: N802 — http.server API
            if self.path.split("?")[0] not in ("/metrics", "/"):
                self.send_response(404)
                self.end_headers()
                return
            body = registry.prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):    # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m lux_tpu_torch.metrics",
        description="Prometheus text endpoint over the process "
                    "default metrics registry (stdlib http only)")
    ap.add_argument("-serve", type=int, default=None, metavar="PORT",
                    help="serve /metrics on PORT until interrupted")
    ap.add_argument("-host", default="127.0.0.1")
    ap.add_argument("-demo", action="store_true",
                    help="populate the registry with a demo series "
                         "set first (so a fresh endpoint renders "
                         "something scrapeable)")
    args = ap.parse_args(argv)

    reg = default_registry()
    if args.demo:
        rngv = [0.001 * (i % 37 + 1) for i in range(200)]
        for kind in ("sssp", "pagerank"):
            reg.counter("serve_queries_total", kind=kind).inc(100)
            h = reg.histogram("serve_latency_seconds", kind=kind)
            for v in rngv:
                h.observe(v)
    if args.serve is None:
        print(reg.prometheus_text(), end="")
        return 0
    srv = serve_http(reg, args.serve, host=args.host)
    print(f"# serving /metrics on http://{args.host}"
          f":{srv.server_address[1]}")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
