"""The plain reference that decides ``correct``: plain PyTorch and numpy,
recomputing every output from the meshes the benchmark made.  It imports
nothing of the program under test."""
