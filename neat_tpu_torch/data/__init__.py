"""Scene data: wireframes, attraction support, PNG images, synthetic scenes
and the packed scene loader (port of neat_tpu/data/)."""
