"""Per-layer metric readers, one file each, found by the metric's name in
`BENCHMARK.json`. Each defines `read(run) -> float | None`: `run.frames`
(one record per window frame: `j`, `frame`, `span_ms` (CUDA events around
`add_frame` in a traced run), `is_keyframe`, `tracked`, `k1`, `k2` (the
step's launches the card counted), `other_work` (a loop closure or a
relocalization ran inside the frame)), `run.calls` (the session's program
calls in the window), `run.closures`, `run.trace` (`slambench.trace.Trace`
of the traced frames, or None), `run.traced` (their records), `run.config`, `run.traffic`,
`run.device_name`, `run.work` (`slambench.work`). A reader that finds
nothing to read returns None and the metric is left out."""
