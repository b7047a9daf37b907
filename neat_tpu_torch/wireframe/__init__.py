"""Wireframe finalization and the alternate distillation tools (port of
neat_tpu/wireframe/; debug_tools is not ported, ROADMAP.md §1, periphery)."""
