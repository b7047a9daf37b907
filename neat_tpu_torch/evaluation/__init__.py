"""Evaluation of a trained run: render PSNR and the SDF mesh, the ABC
wireframe protocol (port of neat_tpu/evaluation/; eval_dtu, eval_lsr and
abc_analysis are not ported yet, ROADMAP.md §1)."""
