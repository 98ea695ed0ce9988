"""batch_write_pct: the sum over the window's batches of the busiest lane
writer's time (max of parallel.batch.LAST_TIMINGS["lane_write_s"]: its
routing, flush cuts, CSV rows and FLAC encode), as a percentage of the
window's wall time. Layer batch."""
from harness.readers import share_of_window

UNIT, SOURCE, MOVES = "%", "program_span", "realtime_x"
READS = 'max of stats["timings"]["lane_write_s"] of each batch'


def read(run):
    vals = [max(j.stats["timings"]["lane_write_s"]) for j in run.jobs
            if isinstance(j.stats, dict)
            and (j.stats.get("timings") or {}).get("lane_write_s")]
    return share_of_window(run, sum(vals)) if vals else None
