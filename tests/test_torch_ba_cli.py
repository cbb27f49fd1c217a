"""``python -m toyslam_torch ba3d --device cpu`` (the kernels' plain
versions) against the JAX app's ``ba3d`` at a small size: the same keys
plus the device and the launch count, the same graph (poses, landmarks,
edges, initial ATE), chi^2 first and final at rtol 1e-4 and the final ATE
within 1e-3.  Both run in this process; the subprocess checks of the
command line are in test_torch_app.py.
"""

import contextlib
import io
import json

import numpy as np
import torch

torch.set_num_threads(1)


CLI = ["--poses", "24", "--landmarks", "96", "--iterations", "4"]


def test_cli_ba3d_matches_jax_app():
    from toyslam_tpu import app as j_app

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert j_app.main(["ba3d", *CLI]) == 0
    ref = json.loads(buf.getvalue().strip().splitlines()[-1])
    from toyslam_torch import app

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert app.main(["ba3d", *CLI, "--device", "cpu"]) == 0
    m = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(m) == set(ref) | {"device", "kernel_launches"}
    assert m["device"] == "cpu" and m["kernel_launches"] == 0
    for k in ("cmd", "poses", "landmarks", "reproj_edges", "ate_initial"):
        assert m[k] == ref[k], k
    assert m["iterations_run"] == ref["iterations_run"]
    for k in ("chi2_first", "chi2_final"):
        assert np.isclose(m[k], ref[k], rtol=1e-4), k
    assert abs(m["ate_final"] - ref["ate_final"]) <= 1e-3
