"""Mesh and volume file formats (.stl, .vti, .s3d)."""
