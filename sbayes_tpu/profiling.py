"""Device time from a ``jax.profiler`` trace, attributed to named scopes.

A program marks a region with ``jax.named_scope(name)``; the scope lands in
the ``op_name`` metadata of the HLO instructions it produced. The compiled
HLO text maps instruction names to that metadata, and the trace's device
events name the instruction each kernel ran (stat ``hlo_op``, or the event
name itself); on a GPU each kernel event also carries the scope path
(stat ``name``). ``summarize`` puts them together: busy and idle share of
the device over the traced window, and the device time of the marked
instructions.
"""
from __future__ import annotations

import glob
import os
import re

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?metadata=\{[^}]*op_name=\"([^\"]*)\"")


def _norm(name: str) -> str:
    return name.lstrip("%").replace(".", "_")


def hlo_op_names(hlo_text: str) -> dict[str, str]:
    """Instruction name -> ``op_name`` metadata of a compiled HLO module."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            out[_norm(m.group(1))] = m.group(2)
    return out


def scoped_ops(hlo_text: str, scope: str) -> set[str]:
    """Instructions whose op_name path contains the named scope ``scope``."""
    return {name for name, op in hlo_op_names(hlo_text).items()
            if f"/{scope}/" in f"/{op}/"}


def load_profile(trace_dir: str):
    """The ``ProfileData`` of the newest trace written under ``trace_dir``."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                          "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return ProfileData.from_file(paths[-1])


def device_events(profile, plane_prefix: str = "/device:GPU") -> list[tuple[int, int, str, str]]:
    """(start_ns, duration_ns, op, scope path) of every operation that ran
    on the device planes. Lines named ``Stream ...`` hold the kernels on a
    GPU; where a plane has none, every line with XLA op events counts."""
    events = []
    for plane in profile.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None and not streams:
                    continue
                events.append((int(ev.start_ns), int(ev.duration_ns),
                               _norm(str(op if op is not None else ev.name)),
                               str(stats.get("name", ""))))
    return events


def summarize(events: list[tuple[int, int, str, str]], marked: set[str],
              scope: str | None = None) -> dict:
    """Busy time (union of event intervals), window (first start to last
    end), idle share, and the device time and count of the marked events:
    those whose op is in ``marked`` or whose scope path holds ``scope``."""
    if not events:
        raise ValueError("the trace holds no device events")

    def is_marked(op, path):
        return op in marked or (scope is not None and f"/{scope}/" in f"/{path}/")

    spans = sorted((s, s + d) for s, d, _, _ in events)
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    kernel_ns = sum(d for _, d, _, _ in events)
    marked_ns = sum(d for _, d, op, path in events if is_marked(op, path))
    return {
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "kernel_ms": kernel_ns / 1e6,
        "n_events": len(events),
        "marked_ms": marked_ns / 1e6,
        "marked_events": sum(1 for _, _, op, path in events if is_marked(op, path)),
        "marked_share_of_kernel_time": marked_ns / kernel_ns if kernel_ns else 0.0,
    }
