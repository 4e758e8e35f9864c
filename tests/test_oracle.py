"""Cross-validation against the independent scalar NumPy oracle — the
BASELINE acceptance "rendered images allclose to CPU reference at matched
spp and seeds". Same RNG counters, same closed-form samplers, independent
code path (scalar f64 vs wavefront f32 JAX)."""

import numpy as np

from crucible_tpu.models import render
from crucible_tpu.models.scene import Dielectric, Lambertian, Metal, Scene, Sphere

from tests import oracle


def _both(scene_spheres, cam_kwargs, width=24, height=24, spp=4, depth=4, seed=0):
    sc = Scene.new_image(width / height, width)
    cam = sc.scene_cam
    cam.look_from(cam_kwargs["look_from"])
    cam.look_at(cam_kwargs["look_at"])
    cam.set_vfov(cam_kwargs["vfov_deg"])
    if cam_kwargs.get("defocus_deg"):
        cam.set_defocus_angle(cam_kwargs["defocus_deg"])
        cam.set_focus_dist(cam_kwargs.get("focus_dist", 10.0))
    osph = []
    for k, (center, radius, spec) in enumerate(scene_spheres):
        sc.add_element(Sphere(center, radius, spec), f"s{k}")
        if isinstance(spec, Lambertian):
            mat = dict(type=0, albedo=spec.texture.color, prob=spec.scatter_prob)
        elif isinstance(spec, Metal):
            mat = dict(type=1, albedo=spec.albedo, fuzz=spec.fuzz)
        else:
            mat = dict(type=2, ior=spec.refraction_index)
        osph.append(oracle.OracleSphere(center, radius, mat))

    got = render.render_image(sc, samples=spp, max_depth=depth, seed=seed)
    want = oracle.render(osph, cam_kwargs, width, height, spp, depth, seed)
    return np.asarray(got, np.float64), want


CAM = dict(look_from=(0.0, 0.5, 3.0), look_at=(0.0, 0.0, -1.0), vfov_deg=60.0)


class TestOracleAgreement:
    def test_lambertian_scene(self):
        got, want = _both(
            [
                ((0.0, 0.0, -1.0), 0.5, Lambertian.from_color((0.7, 0.3, 0.3))),
                ((0.0, -100.5, -1.0), 100.0, Lambertian.from_color((0.8, 0.8, 0.0))),
            ],
            CAM,
        )
        # f32 wavefront vs f64 scalar: tiny numeric drift can flip a
        # borderline hit on a handful of pixels; everything else matches.
        close = np.isclose(got, want, atol=2e-3).mean()
        assert close > 0.98, f"only {close:.3f} of values agree"
        np.testing.assert_allclose(got.mean(), want.mean(), atol=1e-3)

    def test_metal_and_glass(self):
        got, want = _both(
            [
                ((-0.6, 0.0, -1.0), 0.5, Metal((0.8, 0.8, 0.9), 0.1)),
                ((0.6, 0.0, -1.0), 0.5, Dielectric(1.5)),
                ((0.0, -100.5, -1.0), 100.0, Lambertian.from_color((0.5, 0.7, 0.4))),
            ],
            CAM,
            spp=4,
            depth=6,
        )
        close = np.isclose(got, want, atol=5e-3).mean()
        assert close > 0.95, f"only {close:.3f} of values agree"
        np.testing.assert_allclose(got.mean(), want.mean(), atol=3e-3)

    def test_defocus_camera(self):
        got, want = _both(
            [((0.0, 0.0, -1.0), 0.5, Lambertian.from_color((0.2, 0.6, 0.2)))],
            dict(
                look_from=(0.0, 0.0, 3.0),
                look_at=(0.0, 0.0, -1.0),
                vfov_deg=45.0,
                defocus_deg=2.0,
                focus_dist=4.0,
            ),
            spp=4,
        )
        close = np.isclose(got, want, atol=5e-3).mean()
        assert close > 0.95, f"only {close:.3f} of values agree"


# --------------------------------------------------------------------------
# Full feature matrix (VERDICT r1 #4): triangles (+BVH), checker and image
# textures, spherical skybox, motion blur, emissive — every material x
# texture x geometry x sky combination the demo worlds use, validated
# against the independent scalar oracle at tiny sizes.
# --------------------------------------------------------------------------

import jax.numpy as jnp
import pytest

from crucible_tpu.io.image import load_image_path, write_png
from crucible_tpu.models.scene import (
    CheckerTexture,
    Emissive,
    ImageTexture,
    SolidColor,
    Triangle,
)


def _otex(spec):
    if isinstance(spec, SolidColor):
        return {"kind": "solid", "color": spec.color}
    if isinstance(spec, ImageTexture):
        return {"kind": "image", "img": np.asarray(load_image_path(spec.filename))}
    if isinstance(spec, CheckerTexture):
        return {
            "kind": "checker",
            "inv_scale": 1.0 / spec.scale,
            "even": _otex(spec.even),
            "odd": _otex(spec.odd),
        }
    raise TypeError(spec)


def _omat(spec):
    if isinstance(spec, Lambertian):
        return dict(type=0, albedo=_otex(spec.texture), prob=spec.scatter_prob)
    if isinstance(spec, Metal):
        return dict(type=1, albedo={"kind": "solid", "color": spec.albedo}, fuzz=spec.fuzz)
    if isinstance(spec, Dielectric):
        return dict(type=2, ior=spec.refraction_index)
    if isinstance(spec, Emissive):
        return dict(type=3, emission=spec.emission)
    raise TypeError(spec)


def _setup_cam(sc, cam_kwargs):
    cam = sc.scene_cam
    cam.look_from(cam_kwargs["look_from"])
    cam.look_at(cam_kwargs["look_at"])
    cam.set_vfov(cam_kwargs["vfov_deg"])
    if cam_kwargs.get("defocus_deg"):
        cam.set_defocus_angle(cam_kwargs["defocus_deg"])
    cam.set_focus_dist(cam_kwargs.get("focus_dist", 10.0))


def _tiny_image(tmp_path, name, h=4, w=8):
    rng = np.random.default_rng(7)
    arr = (rng.uniform(0.1, 1.0, (h, w, 3)) * 255).astype(np.uint8)
    path = tmp_path / name
    write_png(path, arr)
    return str(path)


def _agree(got, want, atol, frac, mean_atol):
    got = np.asarray(got, np.float64)
    close = np.isclose(got, want, atol=atol).mean()
    assert close > frac, f"only {close:.3f} of values agree"
    np.testing.assert_allclose(got.mean(), want.mean(), atol=mean_atol)


class TestOracleFeatureMatrix:
    def test_checkered_spheres(self):
        # World-2 analogue (demo_images.rs:112-152): two big checker spheres.
        checker = CheckerTexture.from_colors(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
        cam = dict(look_from=(13.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0), vfov_deg=20.0)
        sc = Scene.new_image(1.5, 18)
        _setup_cam(sc, cam)
        objs = []
        for k, c in enumerate(((0.0, -10.0, 0.0), (0.0, 10.0, 0.0))):
            spec = Lambertian.from_texture(checker)
            sc.add_element(Sphere(c, 10.0, spec), f"s{k}")
            objs.append(oracle.OracleSphere(c, 10.0, _omat(spec)))
        got = render.render_image(sc, samples=4, max_depth=4, seed=1)
        want = oracle.render(objs, cam, 18, 12, 4, 4, 1)
        _agree(got, want, 2e-3, 0.97, 1e-3)

    def test_image_texture_sphere(self, tmp_path):
        # World-4 analogue (demo_images.rs:202-221): image-mapped sphere.
        img_path = _tiny_image(tmp_path, "tex.png")
        spec = Lambertian.from_texture(ImageTexture(img_path))
        cam = dict(look_from=(0.0, 0.0, 12.0), look_at=(0.0, 0.0, 0.0), vfov_deg=20.0)
        sc = Scene.new_image(1.5, 18)
        _setup_cam(sc, cam)
        sc.add_element(Sphere((0.0, 0.0, 0.0), 2.0, spec), "earth")
        got = render.render_image(sc, samples=4, max_depth=4, seed=2)
        want = oracle.render(
            [oracle.OracleSphere((0, 0, 0), 2.0, _omat(spec))], cam, 18, 12, 4, 4, 2
        )
        _agree(got, want, 2e-3, 0.97, 1e-3)

    def test_spherical_skybox_metal(self, tmp_path):
        # World-5 analogue (demo_images.rs:223-242): metal ball + equirect sky.
        sky_path = _tiny_image(tmp_path, "sky.png", h=6, w=12)
        cam = dict(look_from=(0.0, 1.0, 5.0), look_at=(0.0, 0.0, 0.0), vfov_deg=40.0)
        sc = Scene.new_image(1.5, 18)
        _setup_cam(sc, cam)
        spec = Metal((0.9, 0.85, 0.8), 0.05)
        sc.add_element(Sphere((0.0, 0.0, 0.0), 1.0, spec), "ball")
        sc.load_spherical_skybox(sky_path)
        got = render.render_image(sc, samples=4, max_depth=4, seed=3)
        want = oracle.render(
            [oracle.OracleSphere((0, 0, 0), 1.0, _omat(spec))],
            cam, 18, 12, 4, 4, 3,
            sky_img=np.asarray(load_image_path(sky_path)),
        )
        _agree(got, want, 2e-3, 0.97, 1e-3)

    def test_triangle_mesh_bvh(self):
        # World-3 analogue: a 72-triangle grid "floor" (enough to engage the
        # BVH, BVH_MIN_TRIS=64) under a metal sphere.
        cam = dict(look_from=(0.0, 3.0, 6.0), look_at=(0.0, 0.0, 0.0), vfov_deg=35.0)
        sc = Scene.new_image(1.5, 12)
        _setup_cam(sc, cam)
        floor_mat = Lambertian.from_color((0.6, 0.5, 0.2))
        ball = Metal((0.8, 0.8, 0.9), 0.0)
        objs = []
        k = 0
        for gx in range(6):
            for gz in range(6):
                x0, z0 = -3.0 + gx, -3.0 + gz
                quad = [
                    ((x0, 0.0, z0), (x0 + 1, 0.0, z0), (x0 + 1, 0.0, z0 + 1)),
                    ((x0, 0.0, z0), (x0 + 1, 0.0, z0 + 1), (x0, 0.0, z0 + 1)),
                ]
                for tri in quad:
                    sc.add_element(Triangle(*tri, floor_mat), f"t{k}")
                    objs.append(oracle.OracleTriangle(*tri, _omat(floor_mat)))
                    k += 1
        sc.add_element(Sphere((0.0, 1.0, 0.0), 1.0, ball), "ball")
        objs.append(oracle.OracleSphere((0.0, 1.0, 0.0), 1.0, _omat(ball)))
        sd = sc.build()
        assert sd.use_bvh and sd.num_tris == 72
        got = render.render_image(sc, samples=2, max_depth=3, seed=4)
        want = oracle.render(objs, cam, 12, 8, 2, 3, 4)
        _agree(got, want, 2e-3, 0.97, 1.5e-3)

    def test_motion_blur_moving_sphere_and_camera(self):
        # Linear-shutter motion: sphere translates, camera walks; both lerped
        # by the same per-ray STREAM_TIME fraction (sphere.rs:67-69 analogue).
        from crucible_tpu.models.timeline import LERP, WORLD

        cam = dict(look_from=(0.0, 0.5, 4.0), look_at=(0.0, 0.0, 0.0), vfov_deg=40.0)
        sc = Scene.new_image(1.5, 18)
        _setup_cam(sc, cam)
        spec = Lambertian.from_color((0.7, 0.2, 0.2))
        ground = Lambertian.from_color((0.5, 0.7, 0.4))
        sc.add_element(Sphere((0.0, 0.0, 0.0), 0.5, spec), "ball")
        sc.add_element(Sphere((0.0, -100.5, 0.0), 100.0, ground), "ground")
        # Keys at t=1.0: the frame-0 shutter window [0, 1/48] sits strictly
        # inside the ramp -> linear model (no mid-shutter boundary).
        sc.translate_x(4.8, 1.0, LERP, WORLD, "ball")
        sc.cam_translate_y(1.1, 1.0, LERP, WORLD, "from")
        sd = sc.build()
        assert sd.animated and not sd.motion_exact
        got = render.render_image(sc, samples=4, max_depth=3, seed=5)

        t0, t1 = sc.scene_cam.shutter_window()
        ball_tl = [e for e in sc.elements if e.id == 1][0].timeline
        ca, cb = ball_tl.position_at(t0), ball_tl.position_at(t1)
        fa = sc.scene_cam.from_timeline.position_at(t0)
        fb = sc.scene_cam.from_timeline.position_at(t1)
        ocam = dict(cam, look_from=tuple(fa), look_from_d=tuple(fb - fa))
        objs = [
            oracle.OracleSphere(ca, 0.5, _omat(spec), center_d=cb - ca),
            oracle.OracleSphere((0.0, -100.5, 0.0), 100.0, _omat(ground)),
        ]
        want = oracle.render(objs, ocam, 18, 12, 4, 3, 5, animated=True)
        _agree(got, want, 2e-3, 0.97, 1e-3)

    def test_emissive_sphere(self):
        cam = dict(look_from=(0.0, 0.5, 4.0), look_at=(0.0, 0.0, 0.0), vfov_deg=45.0)
        sc = Scene.new_image(1.5, 18)
        _setup_cam(sc, cam)
        glow = Emissive((2.0, 1.0, 0.5))
        ground = Lambertian.from_color((0.4, 0.4, 0.6))
        sc.add_element(Sphere((0.0, 0.3, 0.0), 0.4, glow), "glow")
        sc.add_element(Sphere((0.0, -100.5, 0.0), 100.0, ground), "ground")
        got = render.render_image(sc, samples=4, max_depth=4, seed=6)
        objs = [
            oracle.OracleSphere((0.0, 0.3, 0.0), 0.4, _omat(glow)),
            oracle.OracleSphere((0.0, -100.5, 0.0), 100.0, _omat(ground)),
        ]
        want = oracle.render(objs, cam, 18, 12, 4, 4, 6)
        _agree(got, want, 2e-3, 0.97, 2e-3)

    def test_nested_checker_oracle_only(self):
        # The oracle supports arbitrary checker nesting (the reference's
        # Arc<Textures> composition); the framework's one-level limit is
        # exercised at scene build (see test_io_scene). Pin the oracle's
        # recursion so a future framework extension has a reference.
        inner = {"kind": "checker", "inv_scale": 10.0,
                 "even": {"kind": "solid", "color": (1, 0, 0)},
                 "odd": {"kind": "solid", "color": (0, 1, 0)}}
        outer = {"kind": "checker", "inv_scale": 1.0,
                 "even": inner, "odd": {"kind": "solid", "color": (0, 0, 1)}}
        v = oracle.texture_value(outer, 0.0, 0.0, np.array([0.05, 0.0, 0.0]))
        np.testing.assert_allclose(v, (1, 0, 0))
        v = oracle.texture_value(outer, 0.0, 0.0, np.array([0.15, 0.0, 0.0]))
        np.testing.assert_allclose(v, (0, 1, 0))
        v = oracle.texture_value(outer, 0.0, 0.0, np.array([1.05, 0.0, 0.0]))
        np.testing.assert_allclose(v, (0, 0, 1))

    def test_nested_checker_render(self):
        # Checker-of-checker (the reference's Arc<Textures> composition,
        # checker_texture.rs:12-36), now supported end-to-end via the
        # static nesting unroll in textures.value.
        inner = CheckerTexture.from_colors(0.1, (0.9, 0.1, 0.1), (0.1, 0.9, 0.1))
        outer = CheckerTexture(1.0, inner, SolidColor((0.1, 0.1, 0.9)))
        spec = Lambertian.from_texture(outer)
        cam = dict(look_from=(0.0, 2.0, 4.0), look_at=(0.0, 0.0, 0.0), vfov_deg=40.0)
        sc = Scene.new_image(1.5, 18)
        _setup_cam(sc, cam)
        sc.add_element(Sphere((0.0, -100.5, 0.0), 100.0, spec), "ground")
        sd = sc.build()
        assert sd.tex.max_nest == 2
        got = render.render_image(sc, samples=4, max_depth=3, seed=7)
        want = oracle.render(
            [oracle.OracleSphere((0.0, -100.5, 0.0), 100.0, _omat(spec))],
            cam, 18, 12, 4, 3, 7,
        )
        _agree(got, want, 2e-3, 0.97, 1e-3)
