"""A bounded ``torch.profiler`` span: every device kernel, copy and set
on every stream, and the host ops of every thread, kept in memory."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from portbench import stats


@dataclass
class TraceData:
    t0_ns: int                 # span, on the profiler's (wall) clock
    t1_ns: int
    perf0: float               # the same span on the perf clock
    perf1: float
    device: list = field(default_factory=list)  # (start_ns, end_ns, name)
    host: list = field(default_factory=list)    # (start_ns, end_ns, name)
    kinds: dict = field(default_factory=dict)   # activity -> [n, seconds]

    @property
    def span_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def device_intervals(self) -> list[tuple[int, int]]:
        return stats.clip([(s, e) for s, e, _ in self.device],
                          self.t0_ns, self.t1_ns)

    def busy_s(self) -> float:
        """Seconds of the span in which any device op ran."""
        return stats.union_length(self.device_intervals()) / 1e9

    def kernel_seconds(self, names) -> float:
        """Device seconds, inside the span, of ops whose name contains
        one of `names`."""
        return sum(e - s for s, e, n in self.device
                   if any(k in n for k in names)
                   for s, e in stats.clip([(s, e)], self.t0_ns,
                                          self.t1_ns)) / 1e9


# host spans the harness opens (record_function); the profiler mirrors
# them onto the device's timeline, where they are no device work
HARNESS_SPANS = ("LLMEngine.step",)


def annotation(event) -> bool:
    """Whether a device-side event is a mirrored host annotation."""
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag is not None and flag()) or (
        event.name() in HARNESS_SPANS)


class Span:
    """Start and stop a profiler span; `data` holds it once stopped."""

    def __init__(self):
        import torch

        self._torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        kw = {}
        try:  # host ops of the engine's step thread too
            kw["experimental_config"] = (
                torch._C._profiler._ExperimentalConfig(
                    profile_all_threads=True))
        except (AttributeError, TypeError):
            pass
        self._prof = torch.profiler.profile(
            activities=acts, record_shapes=False, with_stack=False,
            profile_memory=False, **kw)
        self.data: TraceData | None = None
        self._t0 = None

    def start(self) -> None:
        self._prof.start()
        self._t0 = (time.time_ns(), time.perf_counter())

    def stop(self) -> None:
        t1 = (time.time_ns(), time.perf_counter())
        self._prof.stop()
        self.data = TraceData(self._t0[0], t1[0], self._t0[1], t1[1])

    def collect(self) -> TraceData:
        """Read the events into `data` (after the window: slow)."""
        dev_type = self._torch.autograd.DeviceType
        for e in self._prof.profiler.kineto_results.events():
            s = e.start_ns()
            end = s + e.duration_ns()
            if e.device_type() == dev_type.CUDA:
                if annotation(e):
                    continue
                name = e.name() or "<unnamed>"
                self.data.device.append((s, end, name))
                kind = name if name.startswith(("<", "Memcpy", "Memset")) \
                    else "kernel"
                n_s = self.data.kinds.setdefault(kind.split(" ")[0], [0, 0.0])
                n_s[0] += 1
                n_s[1] += e.duration_ns() / 1e9
            elif e.device_type() == dev_type.CPU:
                self.data.host.append((s, end, e.name()))
        return self.data


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    for cut in ("<", "("):
        i = name.find(cut)
        if i > 0:
            name = name[:i]
    name = name.replace("void ", "").strip()
    return name[:width]


def breakdown(data: TraceData, top: int = 10) -> dict:
    """The device ops that took most time, and the longest idle gaps,
    each named by the innermost host op running at its middle."""
    by_name: dict[str, int] = {}
    for s, e, n in data.device:
        for cs, ce in stats.clip([(s, e)], data.t0_ns, data.t1_ns):
            key = short(n)
            by_name[key] = by_name.get(key, 0) + (ce - cs)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(stats.gaps(data.device_intervals(), data.t0_ns,
                             data.t1_ns), key=lambda g: g[0] - g[1])[:top]
    host = sorted(data.host)
    named = []
    for s, e in idle:
        mid = (s + e) // 2
        around = [(he - hs, n) for hs, he, n in host
                  if hs <= mid < he]
        label = min(around)[1] if around else "no host op"
        named.append([label, (e - s) / 1e9])
    return {"device_ops": [[n, v / 1e9] for n, v in ops],
            "idle_gaps": named}
