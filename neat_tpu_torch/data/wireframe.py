"""2D wireframe graph container, the HAWP json data contract (port of
neat_tpu/data/wireframe.py, numpy only).

Vertices, confidences and weighted edges with the frame size, read from
json, and the thresholded line segments. Read once, when a scene is
packed.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np


@dataclass
class WireframeGraph:
    vertices: np.ndarray  # (V, 2) float32, (x, y)
    v_confidences: np.ndarray  # (V,)
    edges: np.ndarray  # (E, 2) int
    weights: np.ndarray  # (E,)
    frame_width: int
    frame_height: int

    @classmethod
    def load_json(cls, fname) -> "WireframeGraph":
        with open(fname, "r") as f:
            data = json.load(f)
        return cls(
            vertices=np.asarray(data["vertices"], dtype=np.float32).reshape(-1, 2),
            v_confidences=np.asarray(data["vertices-score"], dtype=np.float32).reshape(-1),
            edges=np.asarray(data["edges"], dtype=np.int64).reshape(-1, 2),
            weights=np.asarray(data["edges-weights"], dtype=np.float32).reshape(-1),
            frame_width=int(data["width"]),
            frame_height=int(data["height"]),
        )

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    def line_segments(self, threshold: float = 0.05) -> np.ndarray:
        """(L, 5) [x1 y1 x2 y2 score] for edges above the weight threshold
        (reference hawp_util.py:57-69)."""
        keep = self.weights > threshold
        p1 = self.vertices[self.edges[keep, 0]]
        p2 = self.vertices[self.edges[keep, 1]]
        return np.concatenate([p1, p2, self.weights[keep, None]], axis=-1).astype(
            np.float32
        )
