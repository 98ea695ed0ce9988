"""Helpers of the audited job's metric readers (metrics/audit_*.py): the
verifiers' stage timers and counters that drivers/verify_process.py puts
into each job's stats["audit"] ({tool: {"timings", "counters"}}). The
timers are span totals of the program's recorder (utils/trace.py), which
the verifiers keep together with their counters: a tool's entry without
counters holds no spans, and the readers read nothing from it."""
from __future__ import annotations


def tools(run) -> list:
    """Every tool entry of the window's jobs that carries counters."""
    return [t for j in run.jobs if isinstance(j.stats, dict)
            for t in (j.stats.get("audit") or {}).values()
            if isinstance(t, dict) and "counters" in t]


def tool_sum(run, group: str, key: str):
    """The sum over the window's jobs and both tools of t[group][key], or
    None where no tool reports it."""
    vals = [t[group][key] for t in tools(run) if key in t.get(group, {})]
    return sum(vals) if vals else None
