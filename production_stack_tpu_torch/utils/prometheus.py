"""Prometheus metrics on the standard library: a registry and its text
exposition, and a parser of that text.

The machine with the card has no prometheus_client, so the router's
metrics (router/services/metrics_service.py) and its engine scrape
(router/stats/engine_stats.py) use this module. It holds the subset they
use, written to match prometheus_client's text output byte for byte
apart from the ``_created`` timestamps:

- ``Counter`` / ``Gauge`` / ``Histogram`` with label names, ``labels``
  (by position or by name), ``remove`` and ``clear``; ``inc`` / ``set`` /
  ``dec`` / ``observe`` on a child or on an unlabelled metric.
- ``generate_latest(registry)``: families in registration order, children
  in creation order; a counter's samples end in ``_total``; a histogram's
  are its cumulative ``_bucket`` samples (``le`` last bound ``+Inf``),
  ``_count`` and ``_sum``; counters and histograms add a ``_created``
  gauge family after their own. Labels are sorted by name, values
  escaped (backslash, newline, double quote), floats written as Go
  writes them.
- ``text_string_to_metric_families(text)``: the families and samples
  prometheus_client's parser yields for the same text (``Metric`` with
  ``name``, ``documentation``, ``type``, ``samples``; ``Sample`` with
  ``name``, ``labels``, ``value``, ``timestamp``).
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import namedtuple

INF = float("inf")
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75,
                   1.0, 2.5, 5.0, 7.5, 10.0, INF)


def float_to_go_string(d: float) -> str:
    d = float(d)
    if d == INF:
        return "+Inf"
    if d == -INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to exponents sooner than Python
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_value(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(doc: str) -> str:
    return doc.replace("\\", r"\\").replace("\n", r"\n")


class CollectorRegistry:
    def __init__(self) -> None:
        self._metrics: list[_Metric] = []
        self._names: set[str] = set()
        self._lock = threading.Lock()

    def register(self, metric: "_Metric") -> None:
        with self._lock:
            if metric.name in self._names:
                raise ValueError(
                    f"Duplicated timeseries in CollectorRegistry: "
                    f"{metric.name}")
            self._names.add(metric.name)
            self._metrics.append(metric)

    def metrics(self) -> list["_Metric"]:
        with self._lock:
            return list(self._metrics)


REGISTRY = CollectorRegistry()


class _Child:
    __slots__ = ("value", "created")

    def __init__(self) -> None:
        self.value = 0.0
        self.created = time.time()

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount

    def set(self, value: float) -> None:
        self.value = float(value)


class _CounterChild(_Child):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(
                "Counters can only be incremented by non-negative amounts.")
        self.value += amount


class _HistogramChild:
    __slots__ = ("bounds", "counts", "sum", "created")

    def __init__(self, bounds: tuple[float, ...]) -> None:
        self.bounds = bounds
        self.counts = [0.0] * len(bounds)
        self.sum = 0.0
        self.created = time.time()

    def observe(self, amount: float) -> None:
        self.sum += amount
        for i, b in enumerate(self.bounds):
            if amount <= b:
                self.counts[i] += 1
                break


class _Metric:
    type = ""
    _suffix = ""

    def __init__(self, name: str, documentation: str,
                 labelnames=(), registry: CollectorRegistry | None = REGISTRY,
                 **_ignored) -> None:
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = self._new_child()
        if registry is not None:
            registry.register(self)

    def _new_child(self):
        return _Child()

    def labels(self, *values, **kw):
        if not self.labelnames:
            raise ValueError(f"No label names were set when constructing "
                             f"{self.name}")
        if values and kw:
            raise ValueError("Can't pass both *args and **kwargs")
        if kw:
            if set(kw) != set(self.labelnames):
                raise ValueError("Incorrect label names")
            values = tuple(kw[n] for n in self.labelnames)
        elif len(values) != len(self.labelnames):
            raise ValueError("Incorrect label count")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def remove(self, *values) -> None:
        if len(values) != len(self.labelnames):
            raise ValueError("Incorrect label count")
        with self._lock:
            del self._children[tuple(str(v) for v in values)]

    def clear(self) -> None:
        with self._lock:
            self._children = {}

    def _only(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has label names: use labels()")
        return self._children[()]

    def _items(self):
        with self._lock:
            return list(self._children.items())

    def _labels(self, key: tuple[str, ...], **extra) -> dict[str, str]:
        out = dict(zip(self.labelnames, key))
        out.update(extra)
        return out

    def samples(self) -> list[tuple[str, dict, float]]:
        return [(self.name + self._suffix, self._labels(k), c.value)
                for k, c in self._items()]

    def created_samples(self) -> list[tuple[str, dict, float]]:
        return []


class Counter(_Metric):
    type = "counter"
    _suffix = "_total"

    def __init__(self, name: str, documentation: str, *a, **kw) -> None:
        if name.endswith("_total"):
            name = name[:-6]
        super().__init__(name, documentation, *a, **kw)

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def created_samples(self):
        return [(self.name + "_created", self._labels(k), c.created)
                for k, c in self._items()]


class Gauge(_Metric):
    type = "gauge"

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    def set(self, value: float) -> None:
        self._only().set(value)


class Histogram(_Metric):
    type = "histogram"

    def __init__(self, name: str, documentation: str, labelnames=(),
                 registry: CollectorRegistry | None = REGISTRY,
                 buckets=DEFAULT_BUCKETS, **kw) -> None:
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds):
            raise ValueError("Buckets not in sorted order")
        if not bounds or bounds[-1] != INF:
            bounds.append(INF)
        self._bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry, **kw)

    def _new_child(self):
        return _HistogramChild(self._bounds)

    def observe(self, amount: float) -> None:
        self._only().observe(amount)

    def samples(self):
        out = []
        for k, c in self._items():
            acc = 0.0
            for b, n in zip(c.bounds, c.counts):
                acc += n
                out.append((self.name + "_bucket",
                            self._labels(k, le=float_to_go_string(b)), acc))
            out.append((self.name + "_count", self._labels(k), acc))
            out.append((self.name + "_sum", self._labels(k), c.sum))
        return out

    def created_samples(self):
        return [(self.name + "_created", self._labels(k), c.created)
                for k, c in self._items()]


def _sample_line(name: str, labels: dict, value: float) -> str:
    if labels:
        inner = ",".join(f'{k}="{_escape_value(v)}"'
                         for k, v in sorted(labels.items()))
        name = f"{name}{{{inner}}}"
    return f"{name} {float_to_go_string(value)}\n"


def generate_latest(registry: CollectorRegistry = REGISTRY) -> bytes:
    out: list[str] = []
    for m in registry.metrics():
        full = m.name + m._suffix
        doc = _escape_help(m.documentation)
        out.append(f"# HELP {full} {doc}\n# TYPE {full} {m.type}\n")
        out += [_sample_line(*s) for s in m.samples()]
        created = m.created_samples()
        if created:
            out.append(f"# HELP {m.name}_created {doc}\n"
                       f"# TYPE {m.name}_created gauge\n")
            out += [_sample_line(*s) for s in created]
    return "".join(out).encode("utf-8")


# -- parsing -------------------------------------------------------------------
Sample = namedtuple("Sample", ["name", "labels", "value", "timestamp",
                               "exemplar", "native_histogram"],
                    defaults=(None, None, None))


class Metric:
    def __init__(self, name: str, documentation: str, typ: str) -> None:
        self.name = name
        self.documentation = documentation
        # prometheus_client's Metric reads the text format's "untyped"
        # as OpenMetrics' "unknown"
        self.type = "unknown" if typ == "untyped" else typ
        self.unit = ""
        self.samples: list[Sample] = []

    def __repr__(self) -> str:
        return (f"Metric({self.name}, {self.documentation}, {self.type}, "
                f"{self.unit}, {self.samples})")


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_ESCAPES = {"\\\\": "\\", "\\n": "\n", '\\"': '"'}
_ESCAPE_RE = re.compile(r'\\[\\n"]')
_HELP_ESCAPE_RE = re.compile(r"\\[\\n]")
_ALLOWED = {"counter": [""], "gauge": [""],
            "summary": ["_count", "_sum", ""],
            "histogram": ["_count", "_sum", "_bucket"]}


def _unescape(s: str, pattern=_ESCAPE_RE) -> str:
    return pattern.sub(lambda m: _ESCAPES[m.group(0)], s) if "\\" in s else s


def _escaped(s: str, pos: int) -> bool:
    n = 0
    while pos > n and s[pos - 1 - n] == "\\":
        n += 1
    return n % 2 == 1


def _parse_labels(text: str) -> dict[str, str]:
    labels: dict[str, str] = {}
    i, n = 0, len(text)
    while i < n:
        while i < n and text[i] in " ,":
            i += 1
        if i >= n:
            break
        eq = text.index("=", i)
        name = text[i:eq].strip()
        q = text.index('"', eq)
        j = q + 1
        while True:
            j = text.index('"', j)
            if not _escaped(text, j):
                break
            j += 1
        if not _NAME_RE.match(name) or name in labels:
            raise ValueError(f"Invalid labels: {text}")
        labels[name] = _unescape(text[q + 1:j])
        i = j + 1
    return labels


def _parse_value(s: str):
    if s != s.strip() or "_" in s:
        raise ValueError(f"Invalid value: {s!r}")
    try:
        return int(s)
    except ValueError:
        return float(s)


def _parse_sample(line: str) -> Sample:
    brace = -1
    for i, c in enumerate(line):
        if c == "{":
            brace = i
            break
        if c in " \t":
            break
    if brace < 0:
        name, _, rest = line.partition(" ")
        if "\t" in name:
            name, _, rest2 = line.partition("\t")
            rest = rest2
        labels: dict[str, str] = {}
    else:
        name = line[:brace].strip()
        j = brace + 1
        in_q = False
        while j < len(line):
            c = line[j]
            if c == '"' and not _escaped(line, j):
                in_q = not in_q
            elif c == "}" and not in_q:
                break
            j += 1
        labels = _parse_labels(line[brace + 1:j])
        rest = line[j + 1:]
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name:{line}")
    values = [v for v in rest.replace("\t", " ").split(" ") if v.strip()]
    value = _parse_value(values[0])
    ts = _parse_value(values[-1]) / 1000 if len(values) > 1 else None
    return Sample(name, labels, value, ts)


def _build(name: str, doc: str, typ: str, samples: list) -> Metric:
    if typ == "counter":
        if name.endswith("_total"):
            name = name[:-6]
        else:
            samples = [Sample(s.name + "_total", *s[1:]) for s in samples]
    m = Metric(name, doc, typ)
    m.samples = samples
    return m


def text_string_to_metric_families(text: str):
    name, doc, typ = "", "", "untyped"
    samples: list[Sample] = []
    allowed: list[str] = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                continue
            cand = parts[2]
            if not _NAME_RE.match(cand):
                raise ValueError(f"invalid metric name: {cand}")
            if parts[1] == "HELP":
                if cand != name:
                    if name:
                        yield _build(name, doc, typ, samples)
                    name, typ, samples, allowed = cand, "untyped", [], [cand]
                doc = (_unescape(parts[3], _HELP_ESCAPE_RE)
                       if len(parts) == 4 else "")
            else:
                if len(parts) < 4:
                    raise ValueError(f"bad TYPE line: {line}")
                if cand != name:
                    if name:
                        yield _build(name, doc, typ, samples)
                    name, doc, samples = cand, "", []
                typ = parts[3]
                allowed = [name + s for s in _ALLOWED.get(typ, [""])]
        elif line:
            s = _parse_sample(line)
            if s.name in allowed:
                samples.append(s)
                continue
            if name:
                yield _build(name, doc, typ, samples)
            name, doc, typ, samples, allowed = "", "", "untyped", [], []
            yield _build(s.name, "", "untyped", [s])
    if name:
        yield _build(name, doc, typ, samples)
