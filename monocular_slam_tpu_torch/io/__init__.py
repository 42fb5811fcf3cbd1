"""IO: trajectory files, point-cloud export, state snapshots (counterpart of
`monocular_slam_tpu/io/`)."""
