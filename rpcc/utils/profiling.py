"""Device-trace summarization (per-op device time from a `jax.profiler` trace).

The reference prints host wall-clock per pipeline stage
(tools/compress.py:141-150); our stages fuse into one XLA program, so the
honest equivalent is a `jax.profiler` trace aggregated per device op.  The
trace is the ``.xplane.pb`` JAX writes under ``<dir>/plugins/profile/<run>/``,
read with :class:`jax.profiler.ProfileData`; only events on device planes
(``/device:...``) count, so host threads and CPU-backend runs add nothing.
"""

from __future__ import annotations

import collections
import glob
from typing import Iterable, List, Optional, Tuple

# Lines of a device plane that aggregate the kernel events of other lines
# (module / step spans); counting them too would double the time.
_AGGREGATE_LINES = ("XLA Modules", "Steps", "XLA TraceMe", "Launch Stats")


def reduce_device_events(
    events: Iterable[Tuple[str, str, str, float]], top: int = 15
) -> List[Tuple[float, str, int]]:
    """[(plane, line, op name, duration ns)] -> [(ms, op name, count)] over
    device planes, biggest first.  When a device plane has per-stream lines
    (``Stream #...``, as on GPUs), only those count."""
    events = [e for e in events if e[0].startswith("/device:")]
    stream_planes = {p for p, ln, _, _ in events if ln.startswith("Stream")}
    dur: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for plane, line, name, ns in events:
        if line in _AGGREGATE_LINES:
            continue
        if plane in stream_planes and not line.startswith("Stream"):
            continue
        dur[name] += ns
        cnt[name] += 1
    return [(ns / 1e6, name, cnt[name]) for name, ns in dur.most_common(top)]


def latest_xplane(trace_dir: str) -> Optional[str]:
    paths = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))
    return paths[-1] if paths else None


def trace_events(path: str) -> List[Tuple[str, str, str, float]]:
    """All (plane, line, event name, duration ns) of one ``.xplane.pb``; an
    event's ``hlo_op`` stat names it when present."""
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(path).planes:
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                name = stats.get("hlo_op") or ev.name
                out.append((plane.name, line.name, str(name), float(ev.duration_ns)))
    return out


def summarize_trace(trace_dir: str, top: int = 15) -> List[Tuple[float, str, int]]:
    """Returns [(device milliseconds, op name, event count)], biggest first."""
    path = latest_xplane(trace_dir)
    if path is None:
        return []
    return reduce_device_events(trace_events(path), top)


def print_trace_summary(trace_dir: str, top: int = 15, title: str = "one encode") -> None:
    rows = summarize_trace(trace_dir, top)
    if not rows:
        print("(no device events captured)")
        return
    print(f"\nDevice op timings ({title}):")
    for ms, name, n in rows:
        print(f"    {ms:9.3f} ms  {n:6d}x  {name[:80]}")
