"""Write `tests/fixtures/reference_session_key3.npz`: the JAX reference
session over the rendered key-3 course (12 frames, 320x240, seed 0), the
run of `test_torch_slice.reference_run`, with the course's frames as uint8.
`chip_smoke.py` holds the port's session on the card against it, and
`test_torch_slice.py::test_committed_fixture_is_the_reference_run` keeps it
equal to the reference.

    python tests/make_reference_fixture.py      # from the repository root
"""

import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# as tests/conftest.py sets them: the course's textures are drawn with x64 on
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

import numpy as np  # noqa: E402

import port_util  # noqa: E402
import test_torch_slice  # noqa: E402


def main() -> None:
    course = port_util.rendered_course()
    arrays = test_torch_slice.fixture_arrays(test_torch_slice.run_reference(course), course)
    test_torch_slice.FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(test_torch_slice.FIXTURE, **arrays)
    print(f"wrote {test_torch_slice.FIXTURE} ({test_torch_slice.FIXTURE.stat().st_size} bytes): "
          f"tracked {int(arrays['tracked'].sum())}/{len(arrays['tracked'])}, "
          f"keyframes {arrays['keyframes'].tolist()}")


if __name__ == "__main__":
    main()
