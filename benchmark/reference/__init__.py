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
"threshold_dbfs" equals (benchmark/tests/test_benchmark_files.py).

A cell may hold numbers of its own, on further outputs that its driver
hands the check beside the audio and the state CSV (a verifier's report,
say: harness.check.Answer.files, {name: path}). Its workload file names
under "numbers" a module in this directory, which keeps to the rules
above (nothing of the program, nothing of JAX) and defines
  NUMBERS        {name: one line on what it measures}; the cell's limits
                 hold each name
  numbers(answer, x, ref, config, quantise) -> {name: float}
                 the gaps between what the answer's further outputs say
                 and what this module's own plain implementation gives on
                 the same data: the input x and the answer's own samples
                 (answer.pcm or answer.y); ref is the configuration's
                 render() dict for x. 0 is a perfect answer; an answer
                 that lacks an output the module needs reads inf (so does
                 a name the dict leaves out, a NaN, and every name where
                 an output cannot be read: harness.check logs the cause)
  outputs(answer, x, ref, config, quantise, directory) -> {name: path}
                 the further outputs as the program writes them, made by
                 this module's plain implementation at quantise's
                 precision from x and the answer's samples and written
                 under directory: how the lower-precision control
                 (harness/control.py) carries them, so that numbers()
                 reads the program's answers and the control's alike
Outputs of equal bytes are one answer (harness.driving.file_answers), and
numbers() runs once per answer: a driver writes the further outputs so
that they depend on the answer's content alone, not on their path or the
time, and the window's repeats of one input fold to one answer. A cell whose workload names no such module is checked on its audio
and state CSV alone."""
