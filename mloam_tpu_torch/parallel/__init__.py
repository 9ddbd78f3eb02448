"""Pose-graph optimization (single device)."""
