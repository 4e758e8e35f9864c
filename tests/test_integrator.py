"""Integrator/materials/textures behavior tests: semantics anchored to the
reference's ray_color (src/camera/ray_casting.rs:112-152) and materials,
plus renderer-mode equivalence and animated-scene checks."""

import numpy as np
import pytest

from crucible_tpu.models import demo, render
from crucible_tpu.models.scene import (
    Dielectric,
    Emissive,
    Lambertian,
    Metal,
    Scene,
    Sphere,
    Triangle,
)
from crucible_tpu.models.timeline import LERP, LOCAL, NERP


def _simple_scene(material, width=64):
    sc = Scene.new_image(1.0, width)
    cam = sc.scene_cam
    cam.set_samples(4)
    cam.set_max_depth(4)
    cam.look_from((0.0, 0.0, 2.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(40.0)
    sc.add_element(Sphere((0.0, 0.0, 0.0), 0.5, material), "obj")
    return sc


class TestIntegratorSemantics:
    def test_depth_zero_is_black(self):
        sc = _simple_scene(Lambertian.from_color((0.9, 0.9, 0.9)))
        img = render.render_image(sc, samples=2, max_depth=0)
        assert np.all(img == 0.0)  # ray_color depth==0 -> black

    def test_miss_gives_sky_gradient(self):
        sc = Scene.new_image(1.0, 16)
        sc.scene_cam.look_from((0, 0, 2))
        sc.scene_cam.look_at((0, 0, 0))
        sc.add_element(Sphere((0, -1000, 0), 1.0, Lambertian.from_color((0.5,) * 3)), "x")
        sc.elements[0].hide = True
        img = render.render_image(sc, samples=1, max_depth=3)
        # Everything misses: colors between white and (0.5, 0.7, 1.0).
        assert img[..., 2].min() >= 0.69  # blue channel high everywhere
        assert np.all(img[..., 2] >= img[..., 0])  # blue >= red

    def test_deeper_depth_brighter_for_diffuse(self):
        # With depth 1 every hit is terminated black; more bounces recover
        # energy (throughput product form of the recursion).
        sc = _simple_scene(Lambertian.from_color((0.8, 0.8, 0.8)))
        d1 = render.render_image(sc, samples=8, max_depth=1).mean()
        d4 = render.render_image(sc, samples=8, max_depth=4).mean()
        assert d4 > d1

    def test_metal_mirror_center_reflects_sky(self):
        # A fuzz-0 metal sphere head-on reflects the ray back toward the
        # camera -> sky behind the viewer (gradient), never black.
        sc = _simple_scene(Metal((1.0, 1.0, 1.0), 0.0))
        img = render.render_image(sc, samples=4, max_depth=4)
        h, w = img.shape[:2]
        center = img[h // 2, w // 2]
        assert center.min() > 0.2

    def test_emissive_terminates_and_emits(self):
        sc = _simple_scene(Emissive((3.0, 0.0, 0.0)))
        img = render.render_image(sc, samples=4, max_depth=4)
        h, w = img.shape[:2]
        center = img[h // 2, w // 2]
        assert center[0] == pytest.approx(3.0, rel=1e-5)
        assert center[1] == pytest.approx(0.0, abs=1e-6)

    def test_dielectric_transmits_background(self):
        # Glass sphere in front of sky: light passes through, image stays
        # bright (attenuation is white, dielectric.rs:31).
        sc = _simple_scene(Dielectric(1.5))
        img = render.render_image(sc, samples=8, max_depth=8)
        assert img.mean() > 0.5

    def test_lambertian_russian_roulette_prob(self):
        # prob=0.5: half the paths absorb but attenuation compensates by
        # 1/p (lambertian.rs:49-60) -> same expected radiance, more noise.
        full = _simple_scene(Lambertian.from_color((0.7, 0.7, 0.7)))
        rr = _simple_scene(Lambertian.from_color((0.7, 0.7, 0.7), prob=0.5))
        a = render.render_image(full, samples=64, max_depth=4).mean()
        b = render.render_image(rr, samples=64, max_depth=4).mean()
        assert abs(a - b) / a < 0.05

    def test_triangle_scene_renders(self):
        sc = Scene.new_image(1.0, 32)
        sc.scene_cam.look_from((0, 0, 2))
        sc.scene_cam.look_at((0, 0, 0))
        sc.scene_cam.set_vfov(60.0)
        sc.add_element(
            Triangle((-1, -1, 0), (1, -1, 0), (0, 1, 0), Lambertian.from_color((0.9, 0.1, 0.1))),
            "tri",
        )
        img = render.render_image(sc, samples=4, max_depth=3)
        h, w = img.shape[:2]
        # Center hits the triangle (reddish), corners miss (sky blue-ish).
        assert img[h // 2, w // 2, 0] > img[h // 2, w // 2, 2]
        assert img[0, 0, 2] > img[0, 0, 0]


def _fan(sc, n=80):
    """An ``n``-triangle fan (> BVH_MIN_TRIS, so it is BVH-built) over a
    ground sphere."""
    import math

    sc.add_element(
        Sphere((0.0, -100.0, 0.0), 100.0, Lambertian.from_color((0.6, 0.6, 0.2))),
        "ground",
    )
    for i in range(n):
        a0 = 2 * math.pi * i / n
        a1 = 2 * math.pi * (i + 1) / n
        z0 = 0.3 + 0.1 * math.sin(5 * a0)
        sc.add_element(
            Triangle(
                (0.8 * math.cos(a0), z0, 0.8 * math.sin(a0)),
                (1.2 * math.cos(a1), 0.35, 1.2 * math.sin(a1)),
                (0.0, 0.5, 0.0),
                Metal((0.8, 0.7, 0.6), 0.2),
            ),
            f"tri{i}",
        )
    return n


def _fan_scene(movie=False):
    sc = (
        Scene.new_movie(1.0, 48, 24.0, 360.0, 2.0) if movie
        else Scene.new_image(1.0, 48)
    )
    cam = sc.scene_cam
    cam.look_from((0.0, 1.5, 4.0))
    cam.look_at((0.0, 0.3, 0.0))
    cam.set_vfov(45.0)
    n = _fan(sc)
    return sc, n


def _route_book1():
    sc = demo.book1_end_scene(width=48)
    return sc.build(), sc.scene_cam.params(), 48, 27, 4, 8


def _route_animated_camera():
    # Keyframed camera (shutter-varying basis) + defocus.
    from crucible_tpu.models.timeline import LERP, WORLD

    sc = Scene.new_movie(16.0 / 9.0, 64, 24.0, 180.0, 2.0)
    cam = sc.scene_cam
    cam.look_from((0.0, 1.0, -8.0))
    cam.look_at((0.0, 0.5, 0.0))
    cam.set_vfov(40.0)
    cam.set_defocus_angle(0.5)
    cam.set_focus_dist(8.0)
    sc.add_element(
        Sphere((0.0, -100.0, 0.0), 100.0, Lambertian.from_color((0.5, 0.7, 0.3))),
        "ground",
    )
    sc.add_element(
        Sphere((0.0, 1.0, 0.0), 1.0, Lambertian.from_color((0.9, 0.3, 0.2))),
        "ball",
    )
    sc.cam_translate_point((6.0, 2.0, -6.0), 2.0, LERP, WORLD, "from")
    cam.frame = 24  # mid-walk: camera moves within this frame's shutter
    cp = cam.params()
    assert cp.animated
    return sc.build(), cp, cam.image_width, cam.image_height, 8, 6


def _route_triangle_bvh():
    sc, _ = _fan_scene()
    sd = sc.build()
    assert sd.use_bvh
    return sd, sc.scene_cam.params(), 48, 48, 4, 5


def _route_moving_mesh():
    # Every fan triangle rises during the open shutter: linear-shutter
    # vertex deltas through the BVH walk.
    from crucible_tpu.models.timeline import LERP, LOCAL

    sc, n = _fan_scene(movie=True)
    for i in range(n):
        sc.translate_point((0.0, 0.4, 0.0), 2.0, LERP, LOCAL, f"tri{i}")
    sc.scene_cam.frame = 12
    sd = sc.build()
    assert sd.animated and sd.use_bvh and sd.tri_v0_d is not None
    return sd, sc.scene_cam.params(), 48, 48, 4, 5


_ROUTE_SCENES = dict(
    book1=_route_book1,
    animated_camera=_route_animated_camera,
    triangle_bvh=_route_triangle_bvh,
    moving_mesh=_route_moving_mesh,
)


class TestRendererModes:
    def test_persistent_schedules_equal_tiled(self):
        sc = demo.book1_end_scene(width=64)
        sd = sc.build()
        cp = sc.scene_cam.params()
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        a = render.render_image_data(sd, cp, w, h, 4, 8, 0, mode="tiled")
        for schedule in ("pixel", "queue"):
            b = render.render_image_persistent(
                sd, cp, w, h, 4, 8, 0, schedule=schedule
            )
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=schedule)

    @pytest.mark.parametrize(
        "scene", ["book1", "animated_camera", "triangle_bvh", "moving_mesh"]
    )
    def test_gpu_route_matches_tiled(self, scene):
        """The GPU route's forward (the persistent wavefront,
        utils/backend.ROUTES["gpu"]) against the CPU route's lockstep tiles,
        both run here: same RNG streams and decisions, so the images agree
        up to f32 summation order — a silhouette sample may flip where the
        two programs contract a sum differently."""
        from crucible_tpu.utils import backend

        sd, cp, w, h, spp, depth = _ROUTE_SCENES[scene]()
        assert backend.route("gpu", sd).forward == "persistent"
        ref = render.render_image_data(sd, cp, w, h, spp, depth, 0, mode="tiled")
        got = render.render_image_persistent(
            sd, cp, w, h, spp, depth, 0, lanes=4096
        )
        d = np.abs(np.asarray(got) - np.asarray(ref))
        assert (d > 1e-3).mean() < 0.005, d.max()
        assert d.mean() < 1e-3

    def test_seed_changes_noise_not_structure(self):
        sc = demo.smoke_scene(width=48)
        a = render.render_image(sc, samples=4, seed=0)
        b = render.render_image(sc, samples=4, seed=1)
        assert not np.array_equal(a, b)
        assert abs(a.mean() - b.mean()) < 0.02

    def test_render_deterministic(self):
        sc = demo.smoke_scene(width=48)
        a = render.render_image(sc, samples=4, seed=0)
        b = render.render_image(sc, samples=4, seed=0)
        np.testing.assert_array_equal(a, b)


class TestAnimatedScenes:
    def test_static_timeline_matches_plain(self):
        # A scene with a timeline whose keys are in the future renders
        # (at t=0 shutter) very close to the plain static scene — only the
        # within-shutter ramp of the first LERP key differs.
        base = _simple_scene(Lambertian.from_color((0.6, 0.3, 0.3)))
        anim = _simple_scene(Lambertian.from_color((0.6, 0.3, 0.3)))
        anim.translate_x(5.0, 1000.0, LERP, LOCAL, "obj")
        a = render.render_image(base, samples=4, max_depth=3)
        b = render.render_image(anim, samples=4, max_depth=3)
        # LERP ramps from the init time (-0.1), so at t=0 the sphere has
        # already moved ~5 * 0.1/1000 — a few edge pixels flip; the images
        # agree everywhere else (the reference behaves identically).
        assert np.abs(a - b).mean() < 2e-3

    def test_nerp_future_key_is_exact(self):
        base = _simple_scene(Lambertian.from_color((0.6, 0.3, 0.3)))
        anim = _simple_scene(Lambertian.from_color((0.6, 0.3, 0.3)))
        anim.translate_x(5.0, 1000.0, NERP, LOCAL, "obj")
        a = render.render_image(base, samples=4, max_depth=3)
        b = render.render_image(anim, samples=4, max_depth=3)
        np.testing.assert_allclose(a, b, atol=1e-6)

    def test_moved_sphere_moves_in_image(self):
        anim = _simple_scene(Lambertian.from_color((0.9, 0.1, 0.1)))
        anim.translate_x(0.6, 1.0, NERP, LOCAL, "obj")
        anim.scene_cam.frame_rate = 24.0
        img0 = render.render_image(anim, samples=4, max_depth=3)
        anim.scene_cam.frame = 48  # t = 2s, past the keyframe
        img1 = render.render_image(anim, samples=4, max_depth=3)
        h, w = img0.shape[:2]
        # Sphere occupied center at t=0; by t=2 it moved +x (image left/right
        # depends on basis) — center pixel changes from red to sky.
        assert img0[h // 2, w // 2, 0] > img0[h // 2, w // 2, 2]
        assert img1[h // 2, w // 2, 2] > img1[h // 2, w // 2, 0]

    def test_motion_blur_smears(self):
        # A fast-moving sphere within one open shutter produces motion blur:
        # hit region wider than the static sphere.
        anim = _simple_scene(Lambertian.from_color((0.9, 0.1, 0.1)))
        anim.elements[0].radius = 0.25  # small enough to smear inside frame
        anim.scene_cam.shutter_angle = 360.0
        anim.scene_cam.frame_rate = 1.0  # shutter window [0, 1]s
        anim.translate_x(0.55, 1.0, LERP, LOCAL, "obj")
        blurred = render.render_image(anim, samples=64, max_depth=2)
        static = _simple_scene(Lambertian.from_color((0.9, 0.1, 0.1)))
        static.elements[0].radius = 0.25
        static.scene_cam.shutter_angle = 360.0
        static.scene_cam.frame_rate = 1.0
        sharp = render.render_image(static, samples=64, max_depth=2)
        # The smeared sphere's red mass extends along +x: its rightmost
        # red-dominant column lies well beyond the static sphere's.
        def rightmost_red(img):
            cols = np.maximum(img[..., 0] - img[..., 2], 0.0).sum(axis=0)
            return np.nonzero(cols > 0.01)[0].max()

        assert rightmost_red(blurred) > rightmost_red(sharp) + 8


class TestProgressChunking:
    def test_chunked_equals_single_dispatch(self):
        """progress=True renders in sample chunks; the sum must equal the
        single dispatch up to f32 summation order."""
        from crucible_tpu.models import demo, render

        sc = demo.smoke_scene(width=24)
        sd = sc.build()
        cp = sc.scene_cam.params()
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        reports = []
        one = render.render_image_persistent(
            sd, cp, w, h, 9, 6, 3, schedule="pixel"
        )
        chunked = render.render_image_persistent(
            sd, cp, w, h, 9, 6, 3, schedule="pixel",
            progress=lambda d, t, s: reports.append((d, t)),
        )
        np.testing.assert_allclose(chunked, one, rtol=1e-5, atol=1e-6)
        assert reports[-1][0] == 9 and reports[-1][1] == 9
        assert len(reports) >= 2  # intra-render progress actually reported

    def test_queue_sample_start(self):
        from crucible_tpu.models import demo, render

        sc = demo.smoke_scene(width=24)
        sd = sc.build()
        cp = sc.scene_cam.params()
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        one = render.render_image_persistent(sd, cp, w, h, 8, 6, 3, schedule="queue")
        chunked = render.render_image_persistent(
            sd, cp, w, h, 8, 6, 3, schedule="queue", progress=lambda *a: None
        )
        np.testing.assert_allclose(chunked, one, rtol=1e-5, atol=1e-6)

    def test_queue_overflow_guard_raises(self):
        from crucible_tpu.models import demo, render

        sc = demo.smoke_scene(width=24)
        sd = sc.build()
        cp = sc.scene_cam.params()
        with pytest.raises(ValueError, match="overflow int32"):
            render.render_image_persistent(
                sd, cp, 3840, 2160, 500, 6, 3, schedule="queue"
            )
