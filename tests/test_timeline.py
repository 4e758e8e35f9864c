"""Timeline animation anchors ported from the reference's inline tests
(src/timeline/mod.rs:266-350) plus scene-animator integration checks."""

import numpy as np
import pytest

from crucible_tpu.models.timeline import LERP, LOCAL, NERP, WORLD, TransformTimeline


class TestScaleTrack:
    def test_nerp_scaling(self):
        # check_nerp_scaling (timeline/mod.rs:292-309): radius 1 sphere,
        # NERP radius->15 at t=5: before -> 1, at/after -> 15.
        tl = TransformTimeline(init_pos=(2.0, 3.0, 0.0), init_scale=1.0)
        tl.scale_r(15.0, 5.0, NERP)
        assert tl.scale_at(7.0)[0] == pytest.approx(15.0)
        assert tl.scale_at(3.15)[0] == pytest.approx(1.0)

    def test_lerp_scaling(self):
        # check_lerp_scaling (timeline/mod.rs:312-331): LERP to 15 @5 then
        # to 5 @10; at t=5 -> 15; at t=3.15 -> ~10 (ramping from init time
        # -0.1, tolerance 0.2 in the reference).
        tl = TransformTimeline(init_pos=(2.0, 3.0, 0.0), init_scale=1.0)
        tl.scale_r(15.0, 5.0, LERP)
        tl.scale_r(5.0, 10.0, LERP)
        assert tl.scale_at(5.0)[0] == pytest.approx(15.0)
        assert abs(tl.scale_at(3.15)[0] - 10.0) < 0.2
        # Second segment: at t=10 -> 5; midway ramps from 15.
        assert tl.scale_at(10.0)[0] == pytest.approx(5.0)
        assert 5.0 < tl.scale_at(7.5)[0] < 15.0

    def test_per_axis_scale_most_recent_wins(self):
        # A later scale_y key resets untouched axes to identity, matching
        # the reference's single-most-recent-matrix rule
        # (timeline/mod.rs:250-256).
        tl = TransformTimeline(init_scale=1.0)
        tl.scale_x(2.0, 1.0, NERP)
        tl.scale_y(3.0, 2.0, NERP)
        np.testing.assert_allclose(tl.scale_at(1.5), [2.0, 1.0, 1.0])
        np.testing.assert_allclose(tl.scale_at(2.5), [1.0, 3.0, 1.0])


class TestTranslateTrack:
    def test_nerp_translate(self):
        # check_nerp_translate (timeline/mod.rs:334-349).
        tl = TransformTimeline(init_pos=(2.0, 3.0, 1.0))
        tl.translate_x(1.0, 5.0, NERP, LOCAL)
        tl.translate_y(10.0, 3.0, NERP, LOCAL)
        np.testing.assert_allclose(tl.position_at(0.0)[:2], [2.0, 3.0])
        np.testing.assert_allclose(tl.position_at(5.0)[:2], [3.0, 13.0])

    def test_lerp_ramp(self):
        tl = TransformTimeline(init_pos=(0.0, 0.0, 0.0))
        tl.translate_x(10.0, 10.0, LERP, LOCAL)
        # Ramp runs from the init end time (-0.1) to the keyframe.
        assert tl.position_at(10.0)[0] == pytest.approx(10.0)
        assert tl.position_at(20.0)[0] == pytest.approx(10.0)
        assert 4.5 < tl.position_at(5.0)[0] < 5.5

    def test_world_space_targets_absolute(self):
        # World keys move TO the coordinate; delta = target - prev endpoint
        # (transform_builder.rs:365-428).
        tl = TransformTimeline(init_pos=(5.0, 0.0, 0.0))
        tl.translate_x(12.0, 2.0, LERP, WORLD)
        tl.translate_x(-3.0, 4.0, LERP, WORLD)
        assert tl.position_at(2.0)[0] == pytest.approx(12.0)
        assert tl.position_at(4.0)[0] == pytest.approx(-3.0)

    def test_translate_point_square_walk(self):
        # first_movie's camera walk (demo_movies.rs:32-70): world-space
        # waypoints visited in order.
        tl = TransformTimeline(init_pos=(0.0, 0.0, -12.0))
        for p, t in [
            ((12.0, 0.0, 0.0), 2.5),
            ((0.0, 0.0, 12.0), 5.0),
            ((-12.0, 0.0, 0.0), 7.5),
            ((0.0, 0.0, -12.0), 10.0),
        ]:
            tl.translate_point(p, t, LERP, WORLD)
        np.testing.assert_allclose(tl.position_at(2.5), [12, 0, 0], atol=1e-5)
        np.testing.assert_allclose(tl.position_at(5.0), [0, 0, 12], atol=1e-5)
        np.testing.assert_allclose(tl.position_at(10.0), [0, 0, -12], atol=1e-5)
        # Midway between waypoints: linear blend.
        np.testing.assert_allclose(tl.position_at(3.75), [6, 0, 6], atol=1e-5)

    def test_negative_keyframe_rejected(self):
        tl = TransformTimeline()
        with pytest.raises(AssertionError):
            tl.translate_x(1.0, -1.0, LERP, LOCAL)


class TestSceneAnimator:
    def _scene(self):
        from crucible_tpu.models.scene import Lambertian, Scene, Sphere

        sc = Scene.new_image(1.0, 32)
        sc.add_element(
            Sphere((0.0, 0.0, -2.0), 0.5, Lambertian.from_color((0.5, 0.5, 0.5))),
            "ball",
        )
        return sc

    def test_sphere_translate_and_scale_r(self):
        sc = self._scene()
        sc.translate_x(2.0, 1.0, LERP, LOCAL, "ball")
        sc.scale_r(0.25, 1.0, NERP, "ball")
        assert sc.is_animated
        sd = sc.build(t_open=1.0, t_close=1.0)
        el = sc.elements[0]
        np.testing.assert_allclose(el.timeline.position_at(1.0), [2.0, 0.0, -2.0])
        assert el.timeline.scale_at(1.0)[0] == pytest.approx(0.25)
        np.testing.assert_allclose(np.asarray(sd.sph_center[0]), [2.0, 0.0, -2.0])
        assert float(sd.sph_radius[0]) == pytest.approx(0.25)

    def test_type_checks(self):
        sc = self._scene()
        with pytest.raises(TypeError):
            sc.scale_x(2.0, 1.0, LERP, "ball")  # per-axis scale rejects spheres
        with pytest.raises(KeyError):
            sc.translate_x(1.0, 1.0, LERP, LOCAL, "missing")
        # scale_r on a mesh alias is rejected (scene_animator.rs:141-150 —
        # the check that makes the reference's moving_teapot demo panic).
        from crucible_tpu.models.scene import Metal

        sc.load_asset("teapot.obj", "pot", 0.1, (0, 0, 0), Metal((0.5, 0.5, 0.5), 0.0))
        with pytest.raises(TypeError):
            sc.scale_r(0.5, 1.0, LERP, "pot")

    def test_camera_walk_params(self):
        sc = self._scene()
        sc.cam_translate_point((12.0, 0.0, 0.0), 2.5, LERP, WORLD, "from")
        cam = sc.scene_cam
        cam.frame_rate = 24.0
        cam.frame = 60  # t = 2.5s
        cp = cam.params()
        assert cp.animated
        np.testing.assert_allclose(np.asarray(cp.look_from), [12, 0, 0], atol=1e-4)

    def test_shutter_deltas(self):
        sc = self._scene()
        sc.translate_x(4.8, 1.0, LERP, LOCAL, "ball")  # 4.8/1.1 units/s ramp
        # Frame 0 of a 24fps 180-degree shutter: window [0, 1/48].
        sd = sc.build(t_open=0.0, t_close=1.0 / 48.0)
        d = np.asarray(sd.sph_center_d[0])
        assert d[0] == pytest.approx((4.8 / 1.1) / 48.0, rel=1e-3)


class TestExactMidShutter:
    """Keyframes INSIDE the shutter window: the linear-shutter lowering
    deviates from per-ray timeline evaluation, so scene.build must detect
    them and engage the exact per-ray track evaluation (VERDICT r1 #5;
    reference per-ray semantics: src/timeline/mod.rs:233-263)."""

    def _base_scene(self, width=8):
        from crucible_tpu.models.scene import Scene

        # 24 fps, 180-degree shutter: frame-0 window = [0, 1/48).
        return Scene(aspect_ratio=1.0, image_width=width)

    def test_eval_matches_host_scalar(self):
        """The vectorized jit-side evaluators equal the scalar host
        evaluators on a dense time grid (both tracks)."""
        import jax.numpy as jnp

        from crucible_tpu.models.timeline import (
            eval_scale,
            eval_translate,
            pad_scale_tracks,
            pad_tracks,
        )

        tl = TransformTimeline(init_pos=(1.0, -2.0, 3.0), init_scale=2.0)
        tl.translate_x(4.0, 0.5, LERP, LOCAL)
        tl.translate_point((0.0, 1.0, 0.0), 0.8, NERP, WORLD)
        tl.translate_y(-3.0, 1.5, LERP, WORLD)
        tl.scale_r(5.0, 0.6, LERP)
        tl.scale_r(1.0, 1.2, NERP)

        t0, t1, dl = pad_tracks([tl.lower_translate()])
        s0, s1, sf, st = pad_scale_tracks([tl.lower_scale()])
        ts = np.linspace(-0.05, 2.0, 97)
        pos_v = np.asarray(
            eval_translate(jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(dl),
                           jnp.asarray([tl.init_pos], np.float32), jnp.asarray(ts, jnp.float32))
        )[:, 0]
        sc_v = np.asarray(
            eval_scale(jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(sf),
                       jnp.asarray(st), jnp.asarray(ts, jnp.float32))
        )[:, 0]
        for i, t in enumerate(ts):
            np.testing.assert_allclose(pos_v[i], tl.position_at(t), atol=1e-5)
            np.testing.assert_allclose(sc_v[i], tl.scale_at(t), atol=1e-5)

    def test_detection(self):
        from crucible_tpu.models.scene import Lambertian, Sphere

        # Key at t=0.01 (inside [0, 1/48)): exact mode engages.
        sc = self._base_scene()
        sc.add_element(Sphere((0, 0, -3), 1.0, Lambertian.from_color((0.5, 0.5, 0.5))), "b")
        sc.translate_x(2.0, 0.01, NERP, WORLD, "b")
        sd = sc.build()
        assert sd.motion_exact
        from crucible_tpu.models import replay as replay_mod
        from crucible_tpu.utils import backend

        # Exact mode caps the persistent wavefront's lanes on every route.
        assert backend.route("gpu", sd).lanes == backend.EXACT_MOTION_MAX_LANES
        # Replay COVERS exact scenes as of r4 (per-winner track evaluation).
        assert replay_mod.replay_supported(sd)

        # Key at t=0.5 (outside the window): linear model stays.
        sc2 = self._base_scene()
        sc2.add_element(Sphere((0, 0, -3), 1.0, Lambertian.from_color((0.5, 0.5, 0.5))), "b")
        sc2.translate_x(2.0, 0.5, LERP, WORLD, "b")
        sd2 = sc2.build()
        assert sd2.animated and not sd2.motion_exact

    def test_sphere_nerp_teleport(self):
        """A sphere that NERP-teleports into view mid-shutter: each ray sees
        it iff its stochastic time is past the key — per-ray step semantics
        the linear model cannot produce. Compared against a direct per-ray
        reference computed from the same RNG stream."""
        import jax.numpy as jnp

        from crucible_tpu.models import integrator, skybox
        from crucible_tpu.models.scene import Emissive, Sphere
        from crucible_tpu.utils import rng as crng

        w = h = 8
        spp = 4
        t_mid = 0.01
        emission = (1.0, 0.5, 0.25)
        sc = self._base_scene(width=w)
        # At A=(100,0,0) radius 50 never intersects the 90-degree -z frustum;
        # at B=(0,0,-3) the camera sits inside -> every ray hits.
        sc.add_element(Sphere((100.0, 0.0, 0.0), 50.0, Emissive(emission)), "flash")
        sc.translate_point((0.0, 0.0, -3.0), t_mid, NERP, WORLD, "flash")
        sd = sc.build()
        assert sd.motion_exact

        seed = jnp.uint32(5)
        p = w * h
        pix = jnp.tile(jnp.arange(p, dtype=jnp.uint32), spp)
        smp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), p)
        rad = np.asarray(
            integrator.render_rays(sd, sc.scene_cam.params(), w, h, pix, smp, seed, 4)
        )

        t_open, t_close = sc.scene_cam.shutter_window()
        w_frac = np.asarray(crng.uniform1(pix, smp, crng.STREAM_TIME, seed))
        t_ray = t_open + w_frac * (t_close - t_open)
        from crucible_tpu.models.camera import generate_rays

        _, d, _ = generate_rays(sc.scene_cam.params(), w, h, pix, smp, seed)
        sky = np.asarray(skybox.radiance(sd.sky_kind, sd.sky_image, d))
        expected = np.where((t_ray >= t_mid)[:, None], np.asarray(emission, np.float32), sky)
        np.testing.assert_allclose(rad, expected, atol=1e-5)
        # Sanity: the window straddles the key (both branches exercised).
        assert 0.1 < (t_ray >= t_mid).mean() < 0.9

    def test_radius_nerp_mid_shutter(self):
        """Sphere radius NERP mid-shutter (scale track exact evaluation)."""
        import jax.numpy as jnp

        from crucible_tpu.models import integrator, skybox
        from crucible_tpu.models.scene import Emissive, Sphere
        from crucible_tpu.utils import rng as crng

        w = h = 8
        spp = 4
        t_mid = 0.012
        emission = (0.2, 0.9, 0.4)
        sc = self._base_scene(width=w)
        # Radius jumps 0.001 -> 50 (camera inside) at t_mid.
        sc.add_element(Sphere((0.0, 0.0, -3.0), 0.001, Emissive(emission)), "grow")
        sc.scale_r(50.0, t_mid, NERP, "grow")
        sd = sc.build()
        assert sd.motion_exact

        seed = jnp.uint32(9)
        p = w * h
        pix = jnp.tile(jnp.arange(p, dtype=jnp.uint32), spp)
        smp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), p)
        rad = np.asarray(
            integrator.render_rays(sd, sc.scene_cam.params(), w, h, pix, smp, seed, 4)
        )
        t_open, t_close = sc.scene_cam.shutter_window()
        w_frac = np.asarray(crng.uniform1(pix, smp, crng.STREAM_TIME, seed))
        t_ray = t_open + w_frac * (t_close - t_open)
        from crucible_tpu.models.camera import generate_rays

        _, d, _ = generate_rays(sc.scene_cam.params(), w, h, pix, smp, seed)
        sky = np.asarray(skybox.radiance(sd.sky_kind, sd.sky_image, d))
        # Tiny-radius misses are not guaranteed for every direction, but the
        # pre-key sphere (r=1e-3 at z=-3) subtends ~0.02 deg: no 8x8 frustum
        # ray hits it at these seeds; post-key every ray is inside.
        expected = np.where((t_ray >= t_mid)[:, None], np.asarray(emission, np.float32), sky)
        np.testing.assert_allclose(rad, expected, atol=1e-5)

    def test_triangle_exact(self):
        """Brute-force triangle NERP mid-shutter (per-vertex tracks)."""
        import jax.numpy as jnp

        from crucible_tpu.models import integrator, skybox
        from crucible_tpu.models.scene import Emissive, Triangle
        from crucible_tpu.utils import rng as crng

        w = h = 8
        spp = 4
        t_mid = 0.008
        emission = (0.8, 0.1, 0.6)
        sc = self._base_scene(width=w)
        # Huge triangle at z=+5 (behind the camera); NERP local shift to
        # z=-5 covers the whole view.
        tri = Triangle(
            (-1000.0, -1000.0, 5.0),
            (1000.0, -1000.0, 5.0),
            (0.0, 2000.0, 5.0),
            Emissive(emission),
        )
        sc.add_element(tri, "wall")
        sc.translate_point((0.0, 0.0, -10.0), t_mid, NERP, LOCAL, "wall")
        sd = sc.build()
        assert sd.motion_exact and sd.tri_exact

        seed = jnp.uint32(2)
        p = w * h
        pix = jnp.tile(jnp.arange(p, dtype=jnp.uint32), spp)
        smp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), p)
        rad = np.asarray(
            integrator.render_rays(sd, sc.scene_cam.params(), w, h, pix, smp, seed, 4)
        )
        t_open, t_close = sc.scene_cam.shutter_window()
        w_frac = np.asarray(crng.uniform1(pix, smp, crng.STREAM_TIME, seed))
        t_ray = t_open + w_frac * (t_close - t_open)
        from crucible_tpu.models.camera import generate_rays

        _, d, _ = generate_rays(sc.scene_cam.params(), w, h, pix, smp, seed)
        sky = np.asarray(skybox.radiance(sd.sky_kind, sd.sky_image, d))
        expected = np.where((t_ray >= t_mid)[:, None], np.asarray(emission, np.float32), sky)
        np.testing.assert_allclose(rad, expected, atol=1e-5)

    def _grid_wall(self, sc, emission, n=10, ext=300.0, z=5.0, y_off=0.0):
        """2*n*n emissive triangles forming a wall at z (> BVH_MIN_TRIS so
        the scene lowers through the BVH). Returns the aliases."""
        from crucible_tpu.models.scene import Emissive, Triangle

        aliases = []
        for i in range(n):
            for j in range(n):
                x0, x1 = -ext + 2 * ext * i / n, -ext + 2 * ext * (i + 1) / n
                y0 = y_off - ext + 2 * ext * j / n
                y1 = y_off - ext + 2 * ext * (j + 1) / n
                for tag, tri in (
                    ("a", ((x0, y0, z), (x1, y0, z), (x1, y1, z))),
                    ("b", ((x0, y0, z), (x1, y1, z), (x0, y1, z))),
                ):
                    al = f"t{i}_{j}{tag}"
                    sc.add_element(Triangle(*tri, Emissive(emission)), al)
                    aliases.append(al)
        return aliases

    def test_bvh_mesh_exact_teleport(self):
        """Mesh ABOVE the BVH threshold with a NERP key mid-shutter: the
        leaf test evaluates per-candidate vertex timelines at the ray's
        time (ops/traverse.py vertex_fn) — the r3 linear-shutter fallback
        (and its build warning) is gone. Reference behavior anchor:
        src/objects/bvhwrapper.rs:102-106 (per-ray traversal-time
        evaluation)."""
        import jax.numpy as jnp

        from crucible_tpu.models import integrator, skybox
        from crucible_tpu.utils import rng as crng

        w = h = 8
        spp = 4
        t_mid = 0.008
        emission = (0.8, 0.1, 0.6)
        sc = self._base_scene(width=w)
        aliases = self._grid_wall(sc, emission)
        for al in aliases:
            sc.translate_point((0.0, 0.0, -10.0), t_mid, NERP, LOCAL, al)
        sd = sc.build()
        assert sd.use_bvh and sd.motion_exact and sd.tri_exact

        seed = jnp.uint32(2)
        p = w * h
        pix = jnp.tile(jnp.arange(p, dtype=jnp.uint32), spp)
        smp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), p)
        cp = sc.scene_cam.params()
        rad = np.asarray(integrator.render_rays(sd, cp, w, h, pix, smp, seed, 4))
        t_open, t_close = sc.scene_cam.shutter_window()
        w_frac = np.asarray(crng.uniform1(pix, smp, crng.STREAM_TIME, seed))
        t_ray = t_open + w_frac * (t_close - t_open)
        from crucible_tpu.models.camera import generate_rays

        _, d, _ = generate_rays(cp, w, h, pix, smp, seed)
        sky = np.asarray(skybox.radiance(sd.sky_kind, sd.sky_image, d))
        expected = np.where(
            (t_ray >= t_mid)[:, None], np.asarray(emission, np.float32), sky
        )
        np.testing.assert_allclose(rad, expected, atol=1e-5)
        assert 0.1 < (t_ray >= t_mid).mean() < 0.9

    def test_bvh_exact_matches_bruteforce(self, monkeypatch):
        """BVH-exact leaf evaluation equals the (r3-tested) brute-force
        exact path on the SAME mesh with a LERP kink mid-shutter — the
        kink makes the trajectory's extremum interior to the window, so
        this also proves the node bounds enclose the kink (scene.build
        unions bounds over keyframe breakpoints)."""
        import jax.numpy as jnp

        from crucible_tpu.models import integrator
        from crucible_tpu.models import scene as scene_mod

        w = h = 8
        spp = 4
        t_kink = 0.01
        t_end = 0.02
        emission = (0.3, 0.7, 0.5)

        def build(force_brute):
            sc = self._base_scene(width=w)
            # Wall parked BELOW the frustum (top edge y=-400 at z=-5);
            # it rises 400 by the kink (top edge y=0, visible to the lower
            # half of the 90-degree frustum) and sinks back by t_end — so
            # the wall is visible ONLY near the kink, and endpoint-union
            # node bounds would cull it entirely.
            aliases = self._grid_wall(sc, emission, z=-5.0, y_off=-700.0)
            for al in aliases:
                sc.translate_y(400.0, t_kink, LERP, LOCAL, al)
                sc.translate_y(-400.0, t_end, LERP, LOCAL, al)
            if force_brute:
                monkeypatch.setattr(scene_mod, "BVH_MIN_TRIS", 10**9)
            else:
                monkeypatch.setattr(scene_mod, "BVH_MIN_TRIS", 64)
            sd = sc.build()
            return sd, sc.scene_cam.params()

        sd_b, cp = build(False)
        sd_f, _ = build(True)
        assert sd_b.use_bvh and sd_b.tri_exact
        assert not sd_f.use_bvh and sd_f.tri_exact

        seed = jnp.uint32(6)
        p = w * h
        pix = jnp.tile(jnp.arange(p, dtype=jnp.uint32), spp)
        smp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), p)
        a = np.asarray(integrator.render_rays(sd_b, cp, w, h, pix, smp, seed, 4))
        b = np.asarray(integrator.render_rays(sd_f, cp, w, h, pix, smp, seed, 4))
        np.testing.assert_allclose(a, b, atol=1e-5)
        # The wall must actually be visible for some rays (the apex pass).
        assert (np.abs(a - np.asarray(emission, np.float32)) < 1e-4).any()

    def test_camera_exact(self):
        """Camera NERP teleport mid-shutter: ray origins step per ray."""
        import jax.numpy as jnp

        from crucible_tpu.models.camera import generate_rays
        from crucible_tpu.utils import rng as crng

        w = h = 8
        spp = 4
        t_mid = 0.015
        sc = self._base_scene(width=w)
        sc.cam_translate_point((0.0, 5.0, 0.0), t_mid, NERP, WORLD, "from")
        cp = sc.scene_cam.params()
        assert cp.animated and cp.motion_exact

        seed = jnp.uint32(11)
        p = w * h
        pix = jnp.tile(jnp.arange(p, dtype=jnp.uint32), spp)
        smp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), p)
        o, _, times = generate_rays(cp, w, h, pix, smp, seed)
        o = np.asarray(o)
        t_ray = np.asarray(times)
        expected = np.where(
            (t_ray >= t_mid)[:, None],
            np.asarray([0.0, 5.0, 0.0], np.float32),
            np.zeros(3, np.float32),
        )
        np.testing.assert_allclose(o, expected, atol=1e-5)
        assert 0.1 < (t_ray >= t_mid).mean() < 0.9
