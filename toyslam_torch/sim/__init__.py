"""Seeded host-side simulation: environment, trajectory, LiDAR, frontend."""
