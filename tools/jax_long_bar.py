#!/usr/bin/env python
"""The JAX package's long-horizon figure behind chip_smoke.py's
``LONG_ATE_BAR_M``: scripts/long_run.py, unchanged, on a world rendered
without OpenCV.

    JAX_PLATFORMS=cpu python tools/jax_long_bar.py [duration_s] [--preset easy]
        [--chunk 10] [--dtype float32|float64]

``cv2`` is blocked (as on a machine without OpenCV, where the simulator
renders without its Gaussian blur), then scripts/long_run.py runs through
``runpy`` with the given arguments in a temporary working directory, so its
``reports/`` file lands there.  ``--dtype float64`` enables JAX's x64 mode
and makes ``long_horizon_config()`` return the float64 configuration (the
config's ``dtype`` field); the script itself is not changed.  The last line
is the script's JSON result plus ``dtype`` and ``bar_m`` (1.25 x its ATE
rmse).  Defaults: 60 s of the easy preset in chunks of 10 s, float32; that
takes ~15-20 minutes on a CPU (the rendering dominates).
"""

import json
import os
import runpy
import sys
import tempfile

sys.modules["cv2"] = None  # render as a machine without OpenCV does
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv):
    dtype = "float32"
    if "--dtype" in argv:
        i = argv.index("--dtype")
        dtype = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if argv[:1] == [] or argv[0].startswith("-"):
        argv = ["60"] + argv
    if "--chunk" not in argv:
        argv += ["--chunk", "10"]
    if dtype == "float64":
        import jax

        jax.config.update("jax_enable_x64", True)
        import uav_airvision_tpu.config as config_mod

        base = config_mod.long_horizon_config
        config_mod.long_horizon_config = lambda **kw: base(dtype="float64", **kw)
    elif dtype != "float32":
        raise SystemExit(f"--dtype must be float32 or float64, not {dtype!r}")

    script = os.path.join(ROOT, "scripts", "long_run.py")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            sys.argv = [script] + argv
            runpy.run_path(script, run_name="__main__")
            (name,) = os.listdir(os.path.join(tmp, "reports"))
            with open(os.path.join(tmp, "reports", name)) as f:
                result = json.load(f)
        finally:
            os.chdir(cwd)
    result.update(dtype=dtype, bar_m=1.25 * result["ate_rmse_m"])
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
