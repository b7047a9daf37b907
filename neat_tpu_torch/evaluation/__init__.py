"""Evaluation of a trained run: render PSNR and the SDF mesh, the ABC
wireframe protocol and detectability analysis, the DTU surface and
wireframe protocols (port of neat_tpu/evaluation/)."""
