"""Task steps (pose3d evaluation)."""
