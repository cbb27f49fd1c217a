"""Linearization, Schur elimination and the fused PCG solve."""
