"""The benchmark of the PyTorch port (`posenet_tpu_torch`), listed in the
repository's `BENCHMARK.json`.

- `run.py`: one run of one cell, the command the benchmark names.
- `harness.py`: set-up, the window, the traced stretch, the result line;
  finds every piece below by the name a file gives it.
- `systems/<system>.py`: a system under test (`pipeline`: the port's
  `PoseNetPipeline`; the only module importing the port).
- `loops/<loop>.py`: how a traffic mix sends its calls (`closed`).
- `references/<reference>/`: the plain reference, the comparison that
  decides `correct`, and its control (`posenet`); `check.py` draws the
  sample and gives the verdict; `control.py` reads the control on the chip.
- `yardstick.py`, `readers.py`: peaks, operation counts, K2's bound, the
  reduction of a profiler trace; the per-layer metrics' arithmetic.
- `configs/`, `traffic/`, `limits/`, `metrics/`: one file per
  configuration, traffic mix, cell and per-layer metric, found by name.
"""
