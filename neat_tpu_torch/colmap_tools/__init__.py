"""COLMAP file formats (port of neat_tpu/colmap_tools/; only the depth-map
reader and writer the DTU loader uses)."""
