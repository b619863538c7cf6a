"""Task steps and drivers (pose3d training and evaluation)."""
