"""Batch optimizers over factor-graph tensors."""

from toyslam_torch.optimizer.gauss_newton import GaussNewton, OptimizeResult
