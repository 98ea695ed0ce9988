"""batch_decode_pct: the sum over the window's batches of the slowest lane's
decode time (max of parallel.batch.LAST_TIMINGS["lane_decode_s"]: its
reads of the source on the producer's pool, producer.decode spans of
utils/trace.py), as a percentage of the window's wall time. Layer batch."""
from harness.readers import share_of_window

UNIT, SOURCE, MOVES = "%", "program_span", "device_ms_per_audio_min"
READS = 'max of stats["timings"]["lane_decode_s"] of each batch'


def read(run):
    vals = [max(j.stats["timings"]["lane_decode_s"]) for j in run.jobs
            if isinstance(j.stats, dict)
            and (j.stats.get("timings") or {}).get("lane_decode_s")]
    return share_of_window(run, sum(vals)) if vals else None
