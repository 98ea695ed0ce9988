"""peak_device_mb: torch.cuda.max_memory_allocated() after the window,
reset at its start, in MB (10^6 bytes). Layer device."""
UNIT, SOURCE, MOVES = "MB", "program_counter", "device_ms_per_audio_min"
READS = "torch.cuda.max_memory_allocated over the window"


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 1e6
