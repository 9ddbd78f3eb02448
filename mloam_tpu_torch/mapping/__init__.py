"""Keyframe mapping backend: keyframe ring and scan-to-map refinement."""
