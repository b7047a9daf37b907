"""Isosurface extraction and mesh IO (port of neat_tpu/viz/mesh.py)."""
