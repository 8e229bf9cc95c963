"""The frozen mesh builders give the configurations' triangle counts."""
import json

import numpy as np
import pytest

import harness
from reference import meshes


@pytest.mark.parametrize("config,triangles", [("trex14k", 13824),
                                              ("igor6k", 6016)])
def test_triangle_counts(config, triangles):
    cfg = json.loads((harness.HERE / "configs" / f"{config}.json").read_text())
    vertices, faces = meshes.build(cfg["mesh"])
    assert faces.shape == (triangles, 3) == (cfg["triangles"], 3)
    assert faces.min() == 0 and faces.max() == len(vertices) - 1


def test_posed_states_turn_about_the_centre():
    vertices, faces = meshes.displaced_torus(16, 8)
    rng = np.random.default_rng(3)
    colors = meshes.seeded_colors(len(vertices), rng)
    pose = {"rotations": [[-90, 180, 0], [10, -80, 0]], "shift": [0, 0, 2]}
    states = meshes.posed_states(vertices, faces, pose, [0.0, 90.0], colors)
    for s in states:
        v = s["vertices"].astype(np.float64)
        assert np.allclose(v.mean(axis=0), [0, 0, 2], atol=1e-5)
        assert np.isclose(np.sqrt(((v - v.mean(0)) ** 2).sum(1)).max(), 1.0,
                          atol=1e-5)
        assert np.allclose(np.linalg.norm(s["normals"], axis=1), 1, atol=1e-5)
        assert s["colors"].dtype == np.float32
        assert set(np.unique(s["colors"])) <= set(range(256))
    assert not np.allclose(states[0]["vertices"], states[1]["vertices"])
