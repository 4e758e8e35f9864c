"""utils/backend.py: the per-platform route table, the interpret-mode rule
and the compile-cache choice; utils/tree.py: the pytree dataclasses that
replaced flax.struct."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crucible_tpu.models import demo, render
from crucible_tpu.utils import backend


def _scene_class(name):
    """One SceneData per scene class the routes must serve."""
    if name == "spheres":
        return demo.book1_end_scene(width=16).build()
    if name == "image_texture_sky":
        return demo.garden_skybox(width=16).build()
    if name == "nested_checker":
        return demo.nested_checkers(width=16, nest=3).build()
    if name == "exact_motion":
        from crucible_tpu.models.scene import Lambertian, Scene, Sphere
        from crucible_tpu.models.timeline import LOCAL, NERP

        sc = Scene.new_movie(1.0, 16, 24.0, 360.0, 1.0)
        sc.add_element(
            Sphere((0.0, 0.0, 0.0), 0.5, Lambertian.from_color((0.5, 0.5, 0.5))),
            "s",
        )
        sc.translate_x(1.0, 1.0 / 48.0, NERP, LOCAL, "s")  # mid-shutter key
        sd = sc.build()
        assert sd.motion_exact
        return sd
    raise KeyError(name)


SCENE_CLASSES = ["spheres", "image_texture_sky", "nested_checker", "exact_motion"]


@pytest.mark.parametrize("scene", SCENE_CLASSES)
@pytest.mark.parametrize(
    "platform,forward", [("cpu", "tiled"), ("gpu", "persistent")]
)
def test_route_table(platform, forward, scene):
    sd = _scene_class(scene)
    r = backend.route(platform, sd)
    assert r.forward == forward
    assert r.rays_per_pass > 0 and r.lanes > 0
    if sd.motion_exact:
        assert r.lanes <= backend.EXACT_MOTION_MAX_LANES
    else:
        assert r.lanes == backend.ROUTES[platform].lanes


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron", ""])
def test_unknown_platform_raises(platform, monkeypatch):
    if platform == "":
        # No explicit platform: the default backend decides. Make it one
        # the table does not know.
        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(ValueError, match="no route for platform"):
        backend.route(platform or None)


def test_default_route_is_this_platform():
    assert backend.route() == backend.ROUTES["cpu"]


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_routes_never_ask_for_interpret_mode(platform):
    """No route field selects the Pallas interpreter: library code never
    picks ``interpret=`` from the platform (only tests pass it)."""
    r = backend.route(platform)
    assert all("interpret" not in f.name for f in dataclasses.fields(r))
    assert not hasattr(backend, "pallas_interpret")
    assert not hasattr(backend, "on_accelerator")


def test_render_auto_follows_route():
    sc = demo.smoke_scene(width=16)
    sd = sc.build()
    cp = sc.scene_cam.params()
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    auto = render.render_image_data(sd, cp, w, h, 2, 4, 0)
    tiled = render.render_image_data(sd, cp, w, h, 2, 4, 0, mode="tiled")
    np.testing.assert_array_equal(auto, tiled)


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        backend.require_gpu()


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_wins(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert backend.configure_compile_cache() == str(tmp_path)
    # Set in the environment: JAX reads it itself, nothing is changed.
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = backend.configure_compile_cache()
    assert path == str(backend.checkout_dir() / ".jax_cache")
    assert (backend.checkout_dir() / "crucible_tpu").is_dir()
    assert jax.config.jax_compilation_cache_dir == path


def test_import_without_flax():
    """The package imports with flax made unimportable."""
    code = (
        "import sys; sys.modules['flax'] = None; "
        "import crucible_tpu, crucible_tpu.grad, crucible_tpu.cli; "
        "assert 'flax' not in [m.split('.')[0] for m in sys.modules "
        "if sys.modules[m] is not None]"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, timeout=120,
        env={"JAX_PLATFORMS": "cpu", "PATH": ""},
        cwd=str(backend.checkout_dir()),
    )


class TestPytreeDataclass:
    def test_replace_and_static_fields(self):
        sc = demo.book1_end_scene(width=16)
        sd = sc.build()
        cp = sc.scene_cam.params()
        sd2 = sd.replace(mat_fuzz=sd.mat_fuzz + 1.0)
        assert sd2.num_spheres == sd.num_spheres
        np.testing.assert_allclose(
            np.asarray(sd2.mat_fuzz), np.asarray(sd.mat_fuzz) + 1.0
        )
        leaves, treedef = jax.tree_util.tree_flatten(cp)
        assert all(isinstance(x, jax.Array) for x in leaves)
        assert jax.tree_util.tree_unflatten(treedef, leaves).animated == cp.animated
        with pytest.raises(dataclasses.FrozenInstanceError):
            sd.num_spheres = 3

    def test_static_fields_key_jit(self):
        sd = demo.smoke_scene(width=16).build()
        f = jax.jit(lambda s: s.mat_fuzz.sum() + s.num_spheres)
        assert float(f(sd)) == pytest.approx(
            float(jnp.sum(sd.mat_fuzz)) + sd.num_spheres
        )
        tex = sd.tex.replace(max_nest=2)
        assert jax.tree_util.tree_structure(tex) != jax.tree_util.tree_structure(sd.tex)
