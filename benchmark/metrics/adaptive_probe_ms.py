"""adaptive_probe_ms: one probe of the adaptive processor's threshold
search, in ms: the sum over the window's jobs of
stats["timings"]["threshold_search_s"] (adaptive.search spans of
utils/trace.py) over the sum of stats["search_probes"]. A probe is one
min-hold prefix scan on the device and the read-back of its C2 count, so
this is a latency. Layer adaptive plan."""
from harness.readers import stage_seconds

UNIT, SOURCE, MOVES = "ms", "program_span", "realtime_x"
READS = ('stats["timings"]["threshold_search_s"] over stats["search_probes"] '
         'of each job')


def read(run):
    s = stage_seconds(run, "threshold_search_s")
    n = sum(j.stats["search_probes"] for j in run.jobs
            if isinstance(j.stats, dict)
            and "threshold_search_s" in (j.stats.get("timings") or {})
            and "search_probes" in j.stats)
    return None if s is None or n == 0 else 1000.0 * s / n
