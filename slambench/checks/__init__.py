"""A configuration's own `correct` numbers, one module each, found by the
name that the configuration file lists under `"checks"`. Each defines:

- `numbers(ans, gt, collected, traffic, control) -> dict`: the module's
  numbers of a run. `ans` is what `run.collect_answers` gives (the
  window's poses as the host read them, their tracked flags, the sampled
  frames' features, the resident window frames' observations and the map
  points); with `control` its poses, points and observation poses are the
  control's, rounded to bfloat16. `gt` holds the window's true (n, 3, 4)
  world->camera poses, `collected` what `collect` returned (None without
  it), `traffic` the cell's traffic file. A number that is not finite
  fails wherever a limits file names it.
- optionally `collect(sess, lc, first, n) -> dict`: called once the
  session has drained its pending outcomes and before it is freed, with
  the session, its loop closer and the window's first frame and length;
  it returns host copies only. It is the only place where a check may
  touch the port, and it never imports `jax` or the JAX package.

The plain reference a check compares with lives under
`slambench/reference/` and imports nothing of the port."""
