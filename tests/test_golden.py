"""Golden-image regression: tiny fixed-seed renders of the demo worlds,
compared bit-for-bit against committed references (the image-level suite
the reference lacks, SURVEY.md §4). Regenerate goldens ONLY for an
intentional semantic change:

    python -c "..."  # see tests/goldens/README
"""

from pathlib import Path

import numpy as np
import pytest

from crucible_tpu.models import demo, render

GOLDEN = Path(__file__).parent / "goldens" / "golden_v2.npz"
# Renders of the expanded sphere quadratic (|c|^2 - 2 o.c + |o|^2 - r^2)
# that golden_v2 replaced: kept to hold the current renderer to them at the
# silhouette flip bounds.
GOLDEN_V1 = Path(__file__).parent / "goldens" / "golden_v1.npz"

CONFIGS = {
    "smoke": (demo.smoke_scene, dict(width=32), 4, 6),
    "book1": (demo.book1_end_scene, dict(width=32), 2, 6),
    "checker": (demo.checkered_spheres, dict(width=32), 2, 4),
    "earth": (demo.earth, dict(width=32), 2, 4),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden(name):
    fn, kw, spp, depth = CONFIGS[name]
    sc = fn(**kw)
    img = render.render_image(sc, samples=spp, max_depth=depth, seed=0, mode="tiled")
    want = np.load(GOLDEN)[name]
    # Same platform + deterministic RNG: tolerance only for cross-platform
    # f32 contraction-order differences.
    np.testing.assert_allclose(np.asarray(img), want, atol=2e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden_matches_v1_within_flip_bounds(name):
    """Against the goldens of the expanded quadratic: the same image up to
    silhouette samples that rounding flips — under 3% of values off by more
    than 1e-3, mean absolute difference under 3e-3."""
    fn, kw, spp, depth = CONFIGS[name]
    img = render.render_image(fn(**kw), samples=spp, max_depth=depth, seed=0, mode="tiled")
    diff = np.abs(np.asarray(img) - np.load(GOLDEN_V1)[name])
    assert (diff > 1e-3).mean() < 0.03 and diff.mean() < 3e-3


GOLDEN_64 = Path(__file__).parent / "goldens" / "golden_64px_v2.npz"


def test_golden_64px_file_honest():
    """The 64px golden references (tools/make_goldens_64px.py) must stay in
    sync with the CPU tiled reference renderer: all eight worlds plus the
    depth-50 deep-gradient-path config present at 64px, and the cheapest
    world re-rendered here bit-for-bit."""
    z = np.load(GOLDEN_64)
    assert sorted(z.files) == sorted(
        ["smoke_scene", "book1_end_scene", "checkered_spheres", "earth",
         "load_teapot", "garden_skybox", "sphere_stress", "nested_checkers",
         "book1_deep50"]
    )
    for name in z.files:
        assert z[name].shape[1] == 64 and z[name].shape[2] == 3, name
    sc = demo.smoke_scene(width=64)
    img = render.render_image(sc, samples=8, max_depth=8, seed=0, mode="tiled")
    np.testing.assert_allclose(
        np.asarray(img), z["smoke_scene"], atol=2e-5
    )


def test_deep_golden_matches_deep_replay_path():
    """The stored depth-50 golden reproduces through the deep gradient
    path's forward (two-level record + bucketed replay)."""
    import sys

    sys.path.insert(0, str(Path(__file__).parent.parent / "tools"))
    import make_goldens_64px as mg

    img = mg.deep_replay_image(64, 8, 50)
    want = np.load(GOLDEN_64)["book1_deep50"]
    np.testing.assert_allclose(img, want, atol=2e-5)
