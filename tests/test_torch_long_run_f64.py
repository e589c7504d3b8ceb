"""The port's long-horizon run in float64 (the config's ``dtype``) against
the JAX package's float64 chunk loop, on the CPU: test_torch_long_run.py's
cases (24 frames in 3 chunks of 8, tests/torch_long_run_cases.py) with
``dtype="float64"``, at the same bars.  The two front-ends may still flip a
feature on a status threshold, so no closer bar is asked.  A file of its
own: JAX's chunk loop compiles once per dtype (~80 s on one core).
"""

import sys

import pytest
import torch

from tests.torch_long_run_cases import chunks_equal_one_call, check_against_jax, runs
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def runs_f64():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        yield runs("float64")


def test_long_run_float64_matches_jax(runs_f64):
    """(d) The float64 run against JAX's float64 ``run_sequence`` loop, per
    frame and per chunk; the filter's outputs in float64."""
    _, result, outs, _, want, jchunks = runs_f64
    check_against_jax(result, outs, want, jchunks)
    assert result["dtype"] == "float64" and outs.p.dtype == torch.float64


def test_long_run_float64_chunks_equal_one_call(runs_f64):
    """(b) in float64: the chunked run equals one call, bit for bit."""
    tcfg, _, outs, images, _, _ = runs_f64
    chunks_equal_one_call(tcfg, outs, images)
