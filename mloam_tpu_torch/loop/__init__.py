"""Loop closure: scan-context place recognition, registration, pose graph."""
