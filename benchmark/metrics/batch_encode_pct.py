"""batch_encode_pct: the sum over the window's batches of the slowest lane's
encode time (max of parallel.batch.LAST_TIMINGS["lane_encode_s"]: its sink
writes and the encoder's close, writer.encode and writer.close spans of
utils/trace.py), as a percentage of the window's wall time. Layer batch."""
from harness.readers import share_of_window

UNIT, SOURCE, MOVES = "%", "program_span", "device_ms_per_audio_min"
READS = 'max of stats["timings"]["lane_encode_s"] of each batch'


def read(run):
    vals = [max(j.stats["timings"]["lane_encode_s"]) for j in run.jobs
            if isinstance(j.stats, dict)
            and (j.stats.get("timings") or {}).get("lane_encode_s")]
    return share_of_window(run, sum(vals)) if vals else None
