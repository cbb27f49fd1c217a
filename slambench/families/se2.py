"""The SE(2) pose-landmark family: 2D poses (x, y, heading) and 2D
landmarks, odometry and range-bearing edges, the port's
``FactorGraph2D``; judged by the plain float64 reference of
``reference.py`` and the numbers of ``check.gaps``.

What a family (``families/<name>.py``) provides:

* ``program_graph(arrays)``: the program's host graph of the generated
  arrays (``graphs/<kind>.py``'s ``graph``);
* ``optimize(arrays, opt, device, precision)``: the plain reference's
  solve of the configuration's ``optimizer``, with ``poses``,
  ``landmarks``, ``errors`` and ``iterations_run``;
* ``REFERENCE``, ``CONTROL``, ``FLOAT32``: the precisions of the reference,
  of its control and of a plain float32 solve (``calibrate.py``);
* ``gaps(arrays, n_poses, n_landmarks, opt, ref, answers, device)``: the
  compared numbers over answers ``(poses, landmarks, errors)``, each the
  worst, with ``steps`` where errors came (``check.gaps`` says which).
"""

import torch

from slambench import reference
from slambench.check import gaps  # noqa: F401

REFERENCE = reference.REFERENCE
CONTROL = reference.CONTROL
FLOAT32 = reference.Precision(torch.float32, False)


def program_graph(arrays: dict):
    from toyslam_torch.models.graph import graph_from_numpy

    return graph_from_numpy(**arrays)


def optimize(arrays: dict, opt: dict, device, precision):
    return reference.optimize(arrays, opt, device, precision)
