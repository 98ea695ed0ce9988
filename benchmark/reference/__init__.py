"""The plain references the check holds the program to: one module per
processor, or family of processors, in this directory, named by a
configuration's "reference" key (benchmark/configs/<config>.json) and
loaded by harness.spec. A reference module imports nothing of the program
and nothing of JAX, and takes only the input samples the benchmark made.

It defines render(x, config, quantise) -> dict. x is the input samples
[n, C] as floats, as the program read them; config the configuration
file's contents; quantise one of reference.precision's roundings, put
after each stage. The dict holds
  y              float64 [n, C], the output before PCM_24 quantisation
  pcm            int32 [n, C], its PCM_24 values
  levels         each frame's level, dBFS
  states         each frame's gate state: 1 = C1, 2 = C2
  alpha          each frame's crossfade weight, or None where the
                 processor has none (its state CSV has no alpha column)
  rows           the frames the state CSV prints, in its order
  csv_frame_idx  the numbers the state CSV prints in frame_idx for rows
  masked         per frame, True where a gate decision within rounding of
                 a threshold changes its weight: held to level_db alone
  starts         each frame's first sample in the file
  last_cut       the first sample of the file's last flush cut
levels, states, alpha and masked are indexed by frame, rows and starts in
the same numbering.

Where its processor's gate has a threshold fixed by its params, the module
also defines threshold_dbfs(params) -> dBFS, which the configuration's
"threshold_dbfs" equals (benchmark/tests/test_benchmark_files.py)."""
