"""Quality metrics, FVD with its I3D network, and the in-training eval
loops."""
