"""Record/replay gradient path (models/replay.py): the replay's radiance
must match the direct wavefront integrator, and gradients through the
replay must pass the same finite-difference acceptance as direct AD —
including the scenes direct AD could not reach (animated spheres,
triangle meshes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crucible_tpu import grad as G
from crucible_tpu.models import demo, integrator
from crucible_tpu.models import replay as replay_mod
from crucible_tpu.models.camera import generate_rays
from crucible_tpu.models.scene import Lambertian, Metal, Scene, Sphere
from crucible_tpu.models.timeline import LERP, WORLD
from crucible_tpu.ops.gather import take_rows_mm


def _rays(sc, width, height, spp, seed=0):
    sd = sc.build()
    cp = sc.scene_cam.params()
    p = width * height
    pix = jnp.tile(jnp.arange(p, dtype=jnp.uint32), spp)
    smp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), p)
    return sd, cp, pix, smp


def _record_replay_image(sc, spp, depth, seed, split=False):
    """Mean radiance image through the staged record + the forward replay
    (replay_split with early exit when ``split``)."""
    sd, cp, pix, smp = _rays(
        sc, sc.scene_cam.image_width, sc.scene_cam.image_height, spp
    )
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    seed = jnp.uint32(seed)
    o, d, _ = generate_rays(cp, w, h, pix, smp, seed)
    rec = replay_mod.trace_record(sd, o, d, pix, smp, seed, depth)
    if split:
        rad = replay_mod.replay_split(
            sd, o, d, pix, smp, seed, depth, rec,
            split_depth=replay_mod.SPLIT_DEPTH, long_div=replay_mod.LONG_DIV,
            early_exit=True,
        )
    else:
        rad = replay_mod.trace_replay(
            sd, o, d, pix, smp, seed, depth, rec, early_exit=True
        )
    return np.asarray(rad).reshape(spp, h, w, 3).mean(axis=0)


class TestTakeRowsMM:
    def test_matches_take(self):
        table = jnp.asarray(np.random.default_rng(0).normal(size=(37, 8)), jnp.float32)
        idx = jnp.asarray(np.random.default_rng(1).integers(0, 37, 513), jnp.int32)
        np.testing.assert_array_equal(
            np.asarray(take_rows_mm(table, idx)),
            np.asarray(jnp.take(table, idx, axis=0)),
        )

    def test_backward_is_exact_scatter_sum(self):
        table = jnp.ones((5, 2), jnp.float32)
        idx = jnp.asarray([0, 3, 3, 1], jnp.int32)
        g = jax.grad(lambda t: jnp.sum(take_rows_mm(t, idx) * 2.0))(table)
        expect = np.zeros((5, 2), np.float32)
        for i in idx:
            expect[int(i)] += 2.0
        np.testing.assert_allclose(np.asarray(g), expect)


class TestReplayMatchesForward:
    @pytest.mark.parametrize(
        "mk,depth",
        [
            (demo.smoke_scene, 6),
            (demo.book1_end_scene, 8),
            (demo.checkered_spheres, 5),
            (demo.earth, 4),
            (demo.load_teapot, 5),
        ],
    )
    def test_radiance_close(self, mk, depth):
        sc = mk(width=32)
        sd, cp, pix, smp = _rays(sc, 32, sc.scene_cam.image_height, 2)
        o, d, _ = generate_rays(cp, 32, sc.scene_cam.image_height, pix, smp, 0)
        ref = integrator.trace(sd, o, d, pix, smp, jnp.uint32(0), depth)
        got = replay_mod.render_rays_replay(
            sd, cp, 32, sc.scene_cam.image_height, pix, smp, jnp.uint32(0), depth
        )
        # Same decisions, same RNG; only f32 association of the hit-t math
        # differs (per-winner dot vs (R,N) matmul quadratic). Silhouette
        # lanes can land on different-but-valid decision branches when the
        # recomputed t drifts an ulp across the acceptance boundary, so
        # compare means tightly and lanes loosely.
        ref, got = np.asarray(ref), np.asarray(got)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got.mean(0), ref.mean(0), rtol=2e-3, atol=2e-3)
        close = np.isclose(got, ref, rtol=1e-3, atol=1e-3).all(axis=-1)
        assert close.mean() > 0.98, f"only {close.mean():.3f} lanes match"

    def test_moving_mesh_radiance_close(self):
        sc = demo.load_teapot(width=24)
        sc.translate_x(0.4, 1.0, LERP, WORLD, "teapot")
        sc.scene_cam.frame = 6
        h = sc.scene_cam.image_height
        sd, cp, pix, smp = _rays(sc, 24, h, 2)
        assert sd.animated and sd.tri_v0_d is not None
        o, d, _ = generate_rays(cp, 24, h, pix, smp, 0)
        ref = np.asarray(integrator.trace(sd, o, d, pix, smp, jnp.uint32(0), 5))
        got = np.asarray(
            replay_mod.render_rays_replay(sd, cp, 24, h, pix, smp, jnp.uint32(0), 5)
        )
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got.mean(0), ref.mean(0), rtol=5e-3, atol=5e-3)

    def test_animated_scene_radiance_close(self):
        sc = demo.smoke_scene(width=32)
        sc.translate_x(1.0, 1.0, LERP, WORLD, "ball")  # make it animated
        sc.scene_cam.frame = 6
        sd, cp, pix, smp = _rays(sc, 32, sc.scene_cam.image_height, 2)
        assert sd.animated
        o, d, _ = generate_rays(cp, 32, sc.scene_cam.image_height, pix, smp, 0)
        ref = integrator.trace(sd, o, d, pix, smp, jnp.uint32(0), 6)
        got = replay_mod.render_rays_replay(
            sd, cp, 32, sc.scene_cam.image_height, pix, smp, jnp.uint32(0), 6
        )
        ref, got = np.asarray(ref), np.asarray(got)
        np.testing.assert_allclose(got.mean(0), ref.mean(0), rtol=2e-3, atol=2e-3)


def _fd_vs_grad(sc, key, width=32, spp=4, depth=4, eps=1e-3, rel=2e-2, pix_n=None):
    sd = sc.build()
    cp = sc.scene_cam.params()
    height = sc.scene_cam.image_height
    n = pix_n or width * height
    pix = jnp.arange(n, dtype=jnp.uint32)
    target = jnp.zeros((n, 3), jnp.float32)
    params = G.extract_params(sd, cp)
    kw = dict(width=width, height=height, spp=spp, max_depth=depth, method="replay")
    _, grads = G.loss_and_grad(params, sd, cp, target, pix, jnp.uint32(0), **kw)
    g = np.asarray(grads[key])
    idx = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    assert abs(g[idx]) > 0

    def loss_at(delta):
        p2 = dict(params)
        arr = np.asarray(params[key], np.float64).copy()
        arr[idx] += delta
        p2[key] = jnp.asarray(arr, jnp.float32)
        return float(G.l2_loss(p2, sd, cp, target, pix, jnp.uint32(0), **kw))

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    assert g[idx] == pytest.approx(fd, rel=rel), f"{key}: ad={g[idx]} fd={fd}"


class TestReplayFiniteDifference:
    def test_albedo(self):
        _fd_vs_grad(demo.smoke_scene(width=32), "tex_color")

    def test_emission(self):
        sc = Scene.new_image(1.0, 32)
        sc.scene_cam.look_from((0, 0, 2))
        sc.scene_cam.look_at((0, 0, 0))
        sc.scene_cam.set_vfov(40.0)
        from crucible_tpu.models.scene import Emissive

        sc.add_element(Sphere((0, 0, 0), 0.5, Emissive((1.0, 0.5, 0.2))), "light")
        _fd_vs_grad(sc, "mat_emission")

    def test_texel_image(self):
        sc = demo.earth(width=24)
        sd = sc.build()
        cp = sc.scene_cam.params()
        pix = jnp.arange(24 * 13, dtype=jnp.uint32)
        target = jnp.zeros((24 * 13, 3), jnp.float32)
        params = G.extract_params(sd, cp)
        kw = dict(width=24, height=13, spp=2, max_depth=3, method="replay")
        _, grads = G.loss_and_grad(params, sd, cp, target, pix, jnp.uint32(0), **kw)
        g = np.asarray(grads["tex_images"][0])
        assert np.isfinite(g).all() and np.abs(g).max() > 0

    def test_camera_vfov_sky_pixels(self):
        sc = demo.smoke_scene(width=32)
        _fd_vs_grad(sc, "cam_vfov", pix_n=8, spp=2, depth=3, eps=1e-4)

    def test_fuzz_metal_matches_direct_ad(self):
        """Fuzz gradients are boundary-dominated (rotating scatter
        directions flips hit/miss at silhouettes — a term every
        detached-sampling estimator excludes, FD included at eps scale), so
        the acceptance here is estimator EQUIVALENCE: replay must produce
        the same interior gradient as direct reverse-mode AD."""
        sc = Scene.new_image(1.0, 32)
        sc.scene_cam.look_from((0, 0, 2))
        sc.scene_cam.look_at((0, 0, 0))
        sc.scene_cam.set_vfov(40.0)
        sc.add_element(Sphere((0, 0, 0), 0.5, Metal((0.8, 0.7, 0.6), 0.3)), "m")
        sc.add_element(
            Sphere((0, -100.5, 0), 100.0, Lambertian.from_color((0.5, 0.5, 0.5))),
            "ground",
        )
        sd = sc.build()
        cp = sc.scene_cam.params()
        pix = jnp.arange(32 * 32, dtype=jnp.uint32)
        target = jnp.zeros((32 * 32, 3), jnp.float32)
        params = G.extract_params(sd, cp)
        kw = dict(width=32, height=32, spp=4, max_depth=4)
        _, g_ad = G.loss_and_grad(
            params, sd, cp, target, pix, jnp.uint32(0), method="ad", **kw
        )
        _, g_rp = G.loss_and_grad(
            params, sd, cp, target, pix, jnp.uint32(0), method="replay", **kw
        )
        np.testing.assert_allclose(
            np.asarray(g_rp["mat_fuzz"]), np.asarray(g_ad["mat_fuzz"]),
            rtol=1e-3, atol=1e-7,
        )

    def test_moving_sphere_albedo(self):
        """Animated-scene gradients — unreachable for direct AD without an
        (R, N, 3) rematerialization; the replayed quadratic carries them."""
        sc = demo.smoke_scene(width=32)
        sc.translate_x(0.6, 1.0, LERP, WORLD, "ball")
        sc.scene_cam.frame = 6
        assert sc.build().animated
        _fd_vs_grad(sc, "tex_color", depth=4)

    def test_teapot_mesh_albedo(self):
        """Triangle-BVH scene gradients through per-winner Möller-Trumbore."""
        sc = demo.load_teapot(width=24)
        _fd_vs_grad(sc, "tex_color", width=24, spp=2, depth=3, rel=5e-2)

    def test_moving_mesh_albedo(self):
        """Animated triangle meshes replay via per-winner vertex motion
        lerp (VERDICT r2 #7; reference per-vertex timelines
        triangle.rs:15-17)."""
        sc = demo.load_teapot(width=24)
        sc.translate_x(0.5, 1.0, LERP, WORLD, "teapot")
        sc.scene_cam.frame = 6
        sd = sc.build()
        assert sd.animated and sd.tri_v0_d is not None
        assert replay_mod.replay_supported(sd)
        _fd_vs_grad(sc, "tex_color", width=24, spp=2, depth=3, rel=5e-2)

    def test_nested_checker_albedo(self):
        """Nested checkers replay through the full textures.value
        resolution (VERDICT r2 #7; Arc<Textures> composition,
        checker_texture.rs:12-36)."""
        from crucible_tpu.models.scene import CheckerTexture, SolidColor

        inner = CheckerTexture.from_colors(0.1, (0.9, 0.1, 0.1), (0.1, 0.9, 0.1))
        outer = CheckerTexture(1.0, inner, SolidColor((0.1, 0.1, 0.9)))
        sc = Scene.new_image(1.5, 24)
        sc.scene_cam.look_from((0, 2, 4))
        sc.scene_cam.look_at((0, 0, 0))
        sc.scene_cam.set_vfov(40.0)
        sc.add_element(
            Sphere((0, -100.5, 0), 100.0, Lambertian.from_texture(outer)),
            "ground",
        )
        sd = sc.build()
        assert sd.tex.max_nest == 2 and replay_mod.replay_supported(sd)
        _fd_vs_grad(sc, "tex_color", width=24, spp=2, depth=3)


class TestReplayGradientsFinite:
    def test_all_finite_book1(self):
        sc = demo.book1_end_scene(width=32)
        sd = sc.build()
        cp = sc.scene_cam.params()
        pix = jnp.arange(32 * 18, dtype=jnp.uint32)
        target = jnp.zeros((32 * 18, 3), jnp.float32)
        params = G.extract_params(sd, cp)
        kw = dict(width=32, height=18, spp=4, max_depth=4, method="replay")
        _, grads = G.loss_and_grad(params, sd, cp, target, pix, jnp.uint32(0), **kw)
        for k, leaf in grads.items():
            for arr in jax.tree_util.tree_leaves(leaf):
                assert bool(jnp.isfinite(arr).all()), f"non-finite grad in {k}"


class TestRecordFormat:
    def test_flag_bit_layout(self):
        """The packed record word's flag byte layout (replay.F_*)."""
        assert (replay_mod.F_ALIVE, replay_mod.F_HIT, replay_mod.F_TRI,
                replay_mod.F_SCAT, replay_mod.F_FRONT, replay_mod.F_REFL,
                replay_mod.F_DEGEN, replay_mod.F_ROOT1) == (1, 2, 4, 8, 16, 32, 64, 128)


class TestRecordSchedule:
    """Staged record + replay over it (models/replay.py): the lane-narrowed
    replays must reproduce the unsplit replay and the tiled forward."""

    @pytest.mark.parametrize("depth", [8, 14])
    def test_grad_split_matches_unsplit(self, depth):
        """render_rays_replay narrows deep lanes past GRAD_SPLIT_DEPTH with
        static scans (recursively re-splitting every TAIL_SPLIT_DEPTH rows
        at depth 14); value AND gradients must match the unsplit replay
        (the head/tail handoff is bit-exact — same f32 op order, dead tail
        rows contribute nothing)."""
        import functools

        sc = demo.smoke_scene(width=24)
        sd = sc.build()
        cp = sc.scene_cam.params()
        h = sc.scene_cam.image_height
        assert depth > replay_mod.GRAD_SPLIT_DEPTH + 2
        p = 24 * h
        pix = jnp.tile(jnp.arange(p, dtype=jnp.uint32), 2)
        smp = jnp.repeat(jnp.arange(2, dtype=jnp.uint32), p)
        seed = jnp.uint32(0)
        o, d, _ = generate_rays(cp, 24, h, pix, smp, seed)
        rec = replay_mod.trace_record(sd, o, d, pix, smp, seed, depth)

        def loss(params, split):
            sd2, _ = G.apply_params(sd, cp, params)
            if split:
                rad = replay_mod.replay_split(
                    sd2, o, d, pix, smp, seed, depth, rec,
                    split_depth=replay_mod.GRAD_SPLIT_DEPTH,
                    long_div=replay_mod.GRAD_LONG_DIV,
                    early_exit=False,
                )
            else:
                rad = replay_mod.trace_replay(
                    sd2, o, d, pix, smp, seed, depth, rec
                )
            return jnp.mean(rad**2)

        params = G.extract_params(sd, cp)
        v0, g0 = jax.value_and_grad(functools.partial(loss, split=False))(params)
        v1, g1 = jax.value_and_grad(functools.partial(loss, split=True))(params)
        assert float(v0) == pytest.approx(float(v1), rel=1e-6)
        np.testing.assert_allclose(
            np.asarray(g1["tex_color"]), np.asarray(g0["tex_color"]),
            rtol=1e-5, atol=1e-8,
        )

    def test_split_tail_replay_matches_reference(self):
        """max_depth past SPLIT_DEPTH engages the forward head/tail
        lane-narrowing (replay_split, early_exit=True) over staged records;
        radiance must match the tiled reference up to f32 association."""
        from crucible_tpu.models import render

        assert 12 > replay_mod.SPLIT_DEPTH + 2
        sc = demo.garden_skybox(width=24)
        img = _record_replay_image(sc, spp=3, depth=12, seed=0, split=True)
        ref = np.asarray(
            render.render_image(sc, samples=3, max_depth=12, seed=0, mode="tiled")
        )
        d = np.abs(img - ref)
        assert d.mean() < 3e-3 and (d > 1e-3).mean() < 0.03, d.max()


class TestNestedCheckerRecordSchedule:
    def test_deep_nest_matches_tiled(self):
        """The replay's shading resolves a 3-level nested checker (each
        level with its own inv_scale) identically to the tiled reference
        (VERDICT r3 weak #6 — previously unmeasured past one level)."""
        from crucible_tpu.models import render

        sc = demo.nested_checkers(width=24, nest=3)
        assert sc.build().tex.max_nest == 3
        img = _record_replay_image(sc, spp=2, depth=4, seed=0)
        ref = np.asarray(
            render.render_image(sc, samples=2, max_depth=4, seed=0, mode="tiled")
        )
        d = np.abs(img - ref)
        assert d.mean() < 3e-3 and (d > 1e-3).mean() < 0.03, d.max()


class TestReplayExactMotion:
    """Exact per-ray-time scenes (mid-shutter keyframes) are replayable as
    of r4: the replay re-derives winner geometry from the piecewise-linear
    timeline tracks at the lane's absolute time (VERDICT r3 #2). Anchor:
    src/timeline/mod.rs:233-263 evaluated per ray."""

    def _scene(self):
        from crucible_tpu.models.scene import Emissive
        from crucible_tpu.models.timeline import LOCAL, NERP

        sc = Scene(aspect_ratio=1.0, image_width=12)
        sc.add_element(
            Sphere((0, -100.5, -3), 100.0, Lambertian.from_color((0.5, 0.6, 0.4))),
            "ground",
        )
        sc.add_element(Sphere((0, 0, -3), 0.5, Metal((0.8, 0.7, 0.6), 0.2)), "ball")
        sc.add_element(Sphere((1.2, 0.2, -2.5), 0.3, Emissive((0.9, 0.4, 0.2))), "lamp")
        sc.translate_x(0.6, 0.01, NERP, LOCAL, "ball")  # mid-shutter key
        return sc

    def test_forward_matches_integrator(self):
        sc = self._scene()
        sd = sc.build()
        cp = sc.scene_cam.params()
        assert sd.motion_exact and replay_mod.replay_supported(sd)
        w = h = 12
        spp, depth = 2, 6
        p = w * h
        pix = jnp.tile(jnp.arange(p, dtype=jnp.uint32), spp)
        smp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), p)
        seed = jnp.uint32(7)
        ref = np.asarray(integrator.render_rays(sd, cp, w, h, pix, smp, seed, depth))
        rep = np.asarray(
            replay_mod.render_rays_replay(sd, cp, w, h, pix, smp, seed, depth)
        )
        np.testing.assert_allclose(rep, ref, rtol=1e-5, atol=1e-6)

    def test_grads_match_direct_ad(self):
        sc = self._scene()
        sd = sc.build()
        cp = sc.scene_cam.params()
        w = h = 12
        spp, depth = 2, 6
        pix = jnp.arange(w * h, dtype=jnp.uint32)
        target = jnp.zeros((w * h, 3), jnp.float32)
        params = G.extract_params(sd, cp)
        kw = dict(width=w, height=h, spp=spp, max_depth=depth)
        l1, g1 = G.loss_and_grad(
            params, sd, cp, target, pix, jnp.uint32(7), method="replay", **kw
        )
        l2, g2 = G.loss_and_grad(
            params, sd, cp, target, pix, jnp.uint32(7), method="ad", **kw
        )
        assert float(l1) == pytest.approx(float(l2), rel=1e-6)
        for k in ("tex_color", "mat_emission", "mat_fuzz", "cam_vfov"):
            np.testing.assert_allclose(
                np.asarray(g1[k]), np.asarray(g2[k]), rtol=1e-4, atol=1e-7,
                err_msg=k,
            )

    def test_exact_mesh_replay(self):
        """Replay over a mid-shutter BVH mesh (per-winner exact vertex
        tracks, leaf order) matches the staged integrator."""
        from crucible_tpu.models.scene import Emissive, Triangle
        from crucible_tpu.models.timeline import LOCAL, NERP

        sc = Scene(aspect_ratio=1.0, image_width=8)
        n, ext, z = 8, 300.0, 5.0
        emission = (0.8, 0.1, 0.6)
        for i in range(n):
            for j in range(n):
                x0, x1 = -ext + 2 * ext * i / n, -ext + 2 * ext * (i + 1) / n
                y0, y1 = -ext + 2 * ext * j / n, -ext + 2 * ext * (j + 1) / n
                sc.add_element(
                    Triangle((x0, y0, z), (x1, y0, z), (x1, y1, z), Emissive(emission)),
                    f"t{i}_{j}a",
                )
                sc.add_element(
                    Triangle((x0, y0, z), (x1, y1, z), (x0, y1, z), Emissive(emission)),
                    f"t{i}_{j}b",
                )
        for i in range(n):
            for j in range(n):
                for s in "ab":
                    sc.translate_point((0, 0, -10.0), 0.008, NERP, LOCAL, f"t{i}_{j}{s}")
        sd = sc.build()
        cp = sc.scene_cam.params()
        assert sd.use_bvh and sd.tri_exact and replay_mod.replay_supported(sd)
        w, h, spp, depth = 8, 8, 4, 4
        p = w * h
        pix = jnp.tile(jnp.arange(p, dtype=jnp.uint32), spp)
        smp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), p)
        seed = jnp.uint32(2)
        ref = np.asarray(integrator.render_rays(sd, cp, w, h, pix, smp, seed, depth))
        rep = np.asarray(
            replay_mod.render_rays_replay(sd, cp, w, h, pix, smp, seed, depth)
        )
        np.testing.assert_allclose(rep, ref, rtol=1e-5, atol=1e-6)


class TestBucketedReplay:
    """Depth-bucketed replay (replay.replay_bucketed, the r4 deep-budget
    gradient path): lanes are partitioned by recorded path depth into
    static scan lengths; narrow buckets re-walk head rows from regenerated
    primary rays (integer-only compaction) and accumulate radiance only
    past the head — values and gradients must match the unsplit replay."""

    def _shell_scene(self):
        from crucible_tpu.models.scene import Emissive

        # Fuzzy-metal enclosure -> a long spread of path depths (some lanes
        # reach max_depth); emissive ball -> HIT rows contribute radiance,
        # so any double counting by the accum_from mask is caught.
        sc = Scene.new_image(1.0, 24)
        sc.scene_cam.look_from((0, 0, 0))
        sc.scene_cam.look_at((0, 0, -1))
        sc.scene_cam.set_vfov(70.0)
        sc.add_element(
            Sphere((0, 0, 0), 10.0, Metal((0.85, 0.8, 0.75), 0.4)), "shell"
        )
        sc.add_element(Sphere((0, 1.5, -4), 1.0, Emissive((0.6, 0.5, 0.4))), "lamp")
        sc.add_element(
            Sphere((0, -2.5, -4), 1.2, Lambertian.from_color((0.4, 0.5, 0.6))),
            "ball",
        )
        return sc

    def test_matches_unsplit_value_and_grads(self):
        import functools

        sc = self._shell_scene()
        sd = sc.build()
        cp = sc.scene_cam.params()
        h = sc.scene_cam.image_height
        depth = 20
        p = 24 * h
        pix = jnp.tile(jnp.arange(p, dtype=jnp.uint32), 2)
        smp = jnp.repeat(jnp.arange(2, dtype=jnp.uint32), p)
        seed = jnp.uint32(0)
        o0, d0, _ = generate_rays(cp, 24, h, pix, smp, seed)
        rec = replay_mod.trace_record(sd, o0, d0, pix, smp, seed, depth)
        depth_lane = np.asarray(
            ((np.asarray(rec) & replay_mod.F_ALIVE) > 0).sum(0)
        )
        assert (depth_lane > 8).any() and (depth_lane == depth).any()

        # Last bucket full width (this scene's deep survivors exceed any
        # narrow capacity — that case is the overflow test below); the
        # middle bucket genuinely narrows.
        spec = ((4, 1), (8, 2), (0, 1))

        def loss(params, bucketed):
            sd2, cp2 = G.apply_params(sd, cp, params)
            o, d, _ = generate_rays(cp2, 24, h, pix, smp, seed)
            if bucketed:
                rad = replay_mod.replay_bucketed(
                    sd2, cp2, 24, h, o, d, pix, smp, seed, depth, rec,
                    spec=spec,
                )
            else:
                rad = replay_mod.trace_replay(
                    sd2, o, d, pix, smp, seed, depth, rec
                )
            return jnp.mean(rad**2)

        params = G.extract_params(sd, cp)
        v0, g0 = jax.value_and_grad(functools.partial(loss, bucketed=False))(params)
        v1, g1 = jax.value_and_grad(functools.partial(loss, bucketed=True))(params)
        assert float(v0) == pytest.approx(float(v1), rel=1e-7)
        for k in ("tex_color", "mat_emission", "mat_fuzz", "cam_vfov",
                  "cam_look_from"):
            np.testing.assert_allclose(
                np.asarray(g1[k]), np.asarray(g0[k]), rtol=1e-5, atol=1e-7,
                err_msg=k,
            )

    def test_routed_by_render_rays_replay(self, monkeypatch):
        """render_rays_replay routes deep budgets through the bucketed
        replay (CRUCIBLE_GRAD_BUCKETS honored) and split=False forces the
        unsplit reference — the two must agree."""
        monkeypatch.setenv("CRUCIBLE_GRAD_BUCKETS", "4:1,8:2,0:1")
        sc = self._shell_scene()
        sd = sc.build()
        cp = sc.scene_cam.params()
        h = sc.scene_cam.image_height
        depth = 20
        pix = jnp.arange(24 * h, dtype=jnp.uint32)
        smp = jnp.zeros((24 * h,), jnp.uint32)
        seed = jnp.uint32(3)
        a = replay_mod.render_rays_replay(
            sd, cp, 24, h, pix, smp, seed, depth, split=True
        )
        b = replay_mod.render_rays_replay(
            sd, cp, 24, h, pix, smp, seed, depth, split=False
        )
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)

    def test_two_level_record_matches_unsplit(self, monkeypatch):
        """The two-level record (full-width head + narrow re-record of deep
        survivors, replay.record_two_level) + bucketed replay must equal
        the unsplit replay in value (bit-exact) and gradients: the narrow
        re-record re-traces deep lanes from bounce 0, and decisions are a
        pure function of (pixel, sample, seed)."""
        import functools

        monkeypatch.setenv("CRUCIBLE_GRAD_BUCKETS", "4:1,0:1")
        monkeypatch.setenv("CRUCIBLE_RECORD_DEEP_DIV", "1")
        sc = self._shell_scene()
        sd = sc.build()
        cp = sc.scene_cam.params()
        h = sc.scene_cam.image_height
        depth = 20
        pix = jnp.tile(jnp.arange(24 * h, dtype=jnp.uint32), 2)
        smp = jnp.repeat(jnp.arange(2, dtype=jnp.uint32), 24 * h)
        seed = jnp.uint32(0)

        def loss(params, split):
            sd2, cp2 = G.apply_params(sd, cp, params)
            rad = replay_mod.render_rays_replay(
                sd2, cp2, 24, h, pix, smp, seed, depth, split=split
            )
            return jnp.mean(rad**2)

        params = G.extract_params(sd, cp)
        v0, g0 = jax.value_and_grad(functools.partial(loss, split=False))(params)
        v1, g1 = jax.value_and_grad(functools.partial(loss, split=True))(params)
        assert float(v0) == float(v1)
        for k in ("tex_color", "mat_emission", "mat_fuzz", "cam_vfov"):
            np.testing.assert_allclose(
                np.asarray(g1[k]), np.asarray(g0[k]), rtol=1e-5, atol=1e-7,
                err_msg=k,
            )

    def test_two_level_overflow_poisons(self):
        """Deep lanes beyond the narrow record's capacity poison with NaN."""
        from crucible_tpu.models.camera import generate_rays as gr

        sc = self._shell_scene()
        sd = sc.build()
        cp = sc.scene_cam.params()
        h = sc.scene_cam.image_height
        depth = 20
        pix = jnp.tile(jnp.arange(24 * h, dtype=jnp.uint32), 2)
        smp = jnp.repeat(jnp.arange(2, dtype=jnp.uint32), 24 * h)
        seed = jnp.uint32(0)
        o, d, _ = gr(cp, 24, h, pix, smp, seed)
        rh, rn, idxn, validn, ndeep = replay_mod.record_two_level(
            sd, cp, 24, h, pix, smp, seed, depth, head=4, div=100000
        )
        assert int(ndeep) > rn.shape[1]  # genuinely overflowing
        rad = replay_mod.replay_bucketed_2l(
            sd, cp, 24, h, o, d, pix, smp, seed, depth,
            rh, rn, idxn, validn, ndeep, spec=((4, 1), (0, 2)),
        )
        assert bool(jnp.isnan(rad).any())

    def test_overflow_poisons_loudly(self):
        """Survivors beyond a narrow bucket's static capacity must poison
        the radiance with NaN — loud, never silently truncated."""
        sc = self._shell_scene()
        sd = sc.build()
        cp = sc.scene_cam.params()
        h = sc.scene_cam.image_height
        depth = 20
        pix = jnp.tile(jnp.arange(24 * h, dtype=jnp.uint32), 2)
        smp = jnp.repeat(jnp.arange(2, dtype=jnp.uint32), 24 * h)
        seed = jnp.uint32(0)
        o, d, _ = generate_rays(cp, 24, h, pix, smp, seed)
        rec = replay_mod.trace_record(sd, o, d, pix, smp, seed, depth)
        rad = replay_mod.replay_bucketed(
            sd, cp, 24, h, o, d, pix, smp, seed, depth, rec,
            spec=((4, 1), (8, 2), (0, 4)),
        )
        assert bool(jnp.isnan(rad).any())


class TestTailOverflowGuard:
    def test_overflow_poisons_loudly(self):
        """When more lanes survive the split head than the static tail
        capacity, the differentiable split must return NaN (a loud failed
        finite-check downstream) — never a silently truncated radiance.
        Scene: camera inside a mirror sphere, so EVERY lane survives to
        max_depth."""
        sc = Scene.new_image(1.0, 32)
        sc.scene_cam.look_from((0, 0, 0))
        sc.scene_cam.look_at((0, 0, -1))
        sc.scene_cam.set_vfov(60.0)
        # Enclosing mirror: rays reflect forever (fuzz 0 keeps scatter
        # above the inner surface).
        sc.add_element(Sphere((0, 0, 0), 10.0, Metal((0.9, 0.9, 0.9), 0.0)), "shell")
        sd = sc.build()
        cp = sc.scene_cam.params()
        depth = 8
        # r=2048 lanes: past the 512-lane tail-budget floor, so capacity
        # 2 * max(512, r/4) = 1024 < r survivors.
        p = 32 * 32
        pix = jnp.tile(jnp.arange(p, dtype=jnp.uint32), 2)
        smp = jnp.repeat(jnp.arange(2, dtype=jnp.uint32), p)
        seed = jnp.uint32(0)
        o, d, _ = generate_rays(cp, 32, 32, pix, smp, seed)
        rec = replay_mod.trace_record(sd, o, d, pix, smp, seed, depth)
        depth_lane = np.asarray(
            ((np.asarray(rec) & replay_mod.F_ALIVE) > 0).sum(0)
        )
        assert (depth_lane == depth).all()  # everyone survives
        rad = replay_mod.replay_split(
            sd, o, d, pix, smp, seed, depth, rec,
            split_depth=2, long_div=4, early_exit=False,
        )
        # capacity = TAIL_PASSES * r/4 = r/2 < r survivors -> poisoned.
        assert bool(jnp.isnan(rad).any())
        # The forward (early-exit) variant keeps its full-width cond
        # fallback and stays exact/finite.
        rad_fwd = replay_mod.replay_split(
            sd, o, d, pix, smp, seed, depth, rec,
            split_depth=2, long_div=4, early_exit=True,
        )
        ref = replay_mod.trace_replay(sd, o, d, pix, smp, seed, depth, rec)
        np.testing.assert_allclose(
            np.asarray(rad_fwd), np.asarray(ref), rtol=1e-6, atol=1e-7
        )
