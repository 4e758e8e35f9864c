"""Multi-chip sharding tests on the 8-device virtual CPU mesh: sharded
renders must be bit-identical to single-device (counter RNG), gradients
psum-reduce correctly, and the driver contract (__graft_entry__) holds."""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from crucible_tpu import grad as G
from crucible_tpu.models import demo, integrator
from crucible_tpu.parallel import mesh as mesh_mod


def test_eight_virtual_devices():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"


class TestShardedRender:
    def _render(self, sd, cp, pix, w, h):
        return integrator.render_rays(sd, cp, w, h, pix, jnp.zeros_like(pix), jnp.uint32(0), 4)

    def test_sharded_equals_single(self):
        sc = demo.smoke_scene(width=64)
        sd = sc.build()
        cp = sc.scene_cam.params()
        w, h = 64, 36
        pix = jnp.arange(w * h, dtype=jnp.uint32)

        single = np.asarray(jax.jit(self._render, static_argnums=(3, 4))(sd, cp, pix, w, h))

        mesh = mesh_mod.make_mesh(8)
        sd_r = jax.device_put(sd, mesh_mod.replicated(mesh))
        cp_r = jax.device_put(cp, mesh_mod.replicated(mesh))
        pix_s = jax.device_put(pix, mesh_mod.pixel_sharding(mesh))
        sharded = np.asarray(
            jax.jit(self._render, static_argnums=(3, 4))(sd_r, cp_r, pix_s, w, h)
        )
        np.testing.assert_array_equal(single, sharded)

    def test_mesh_axes(self):
        mesh = mesh_mod.make_mesh(8, sample_parallel=2)
        assert dict(mesh.shape) == {"dp": 4, "sp": 2}

    def test_sharded_gradients_match(self):
        sc = demo.smoke_scene(width=32)
        sd = sc.build()
        cp = sc.scene_cam.params()
        w, h = 32, 18
        pix = jnp.arange(w * h, dtype=jnp.uint32)
        target = jnp.zeros((w * h, 3), jnp.float32)
        params = G.extract_params(sd, cp)
        kw = dict(width=w, height=h, spp=2, max_depth=3)

        loss1, g1 = G.loss_and_grad(params, sd, cp, target, pix, jnp.uint32(0), **kw)

        mesh = mesh_mod.make_mesh(8)
        rep = mesh_mod.replicated(mesh)
        loss2, g2 = G.loss_and_grad(
            jax.device_put(params, rep),
            jax.device_put(sd, rep),
            jax.device_put(cp, rep),
            jax.device_put(target, mesh_mod.pixel_sharding(mesh)),
            jax.device_put(pix, mesh_mod.pixel_sharding(mesh)),
            jnp.uint32(0),
            **kw,
        )
        assert float(loss1) == float(loss2)
        for k in g1:
            for a, b in zip(jax.tree_util.tree_leaves(g1[k]), jax.tree_util.tree_leaves(g2[k])):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


class TestShardedDeepGradient:
    def test_deep_budget_path_shards(self):
        """The r4 deep-gradient machinery (two-level record + depth-
        bucketed replay, max_depth > GRAD_SPLIT_MIN_DEPTH) must compile
        and run under pixel sharding: gradients allclose to single-device;
        the loss may differ at the ulp level (the bucketed compaction's
        cross-shard scatter-adds reduce in a different f32 order — unlike
        the forward render, which stays bit-identical)."""
        sc = demo.smoke_scene(width=32)
        sd = sc.build()
        cp = sc.scene_cam.params()
        w, h = 32, 18
        pix = jnp.arange(w * h, dtype=jnp.uint32)
        target = jnp.zeros((w * h, 3), jnp.float32)
        params = G.extract_params(sd, cp)
        kw = dict(width=w, height=h, spp=2, max_depth=14)

        l1, g1 = G.loss_and_grad(params, sd, cp, target, pix, jnp.uint32(0), **kw)
        mesh = mesh_mod.make_mesh(8)
        rep = mesh_mod.replicated(mesh)
        l2, g2 = G.loss_and_grad(
            jax.device_put(params, rep),
            jax.device_put(sd, rep),
            jax.device_put(cp, rep),
            jax.device_put(target, mesh_mod.pixel_sharding(mesh)),
            jax.device_put(pix, mesh_mod.pixel_sharding(mesh)),
            jnp.uint32(0),
            **kw,
        )
        assert float(l1) == pytest.approx(float(l2), rel=1e-6)
        for k in g1:
            for a, b in zip(
                jax.tree_util.tree_leaves(g1[k]),
                jax.tree_util.tree_leaves(g2[k]),
            ):
                np.testing.assert_allclose(
                    np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-8,
                    err_msg=k,
                )


class TestGraftEntry:
    def _load(self):
        spec = importlib.util.spec_from_file_location("graft", "__graft_entry__.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def test_entry_jits(self):
        g = self._load()
        fn, args = g.entry()
        out = jax.jit(fn)(*args)
        assert out.shape[-1] == 3
        assert bool(jnp.isfinite(out).all())

    def test_dryrun_multichip(self):
        g = self._load()
        g.dryrun_multichip(8)


class TestShardedDriver:
    def test_render_image_sharded_matches_tiled(self):
        from crucible_tpu.models import render as srender
        from crucible_tpu.parallel.render import render_image_sharded

        sc = demo.smoke_scene(width=48)
        sc.scene_cam.set_samples(4)
        sc.scene_cam.set_max_depth(4)
        single = srender.render_image(sc, mode="tiled")
        sharded = render_image_sharded(sc)
        np.testing.assert_array_equal(single, sharded)

    @pytest.mark.parametrize("n_devices", [3, 5, 8])
    def test_chunking_keeps_bits(self, n_devices):
        """Over any number of devices, the same image as one device. Of
        1,296 pixels, 5 devices leave a ragged last block."""
        from crucible_tpu.parallel.render import render_image_sharded

        sc = demo.smoke_scene(width=48)
        kw = dict(samples=2, max_depth=3)
        want = render_image_sharded(sc, mesh_mod.make_mesh(1), **kw)
        got = render_image_sharded(sc, mesh_mod.make_mesh(n_devices), **kw)
        assert got.shape == (27, 48, 3)
        np.testing.assert_array_equal(got, want)

    def test_gpu_route_blocks_match_whole_frame(self):
        """The GPU route's still program (the persistent wavefront) over one
        pixel block per device gives the whole-frame render's bits."""
        from crucible_tpu.models import render as srender
        from crucible_tpu.parallel.render import render_image_sharded

        sc = demo.book1_end_scene(width=40)
        kw = dict(samples=3, max_depth=4)
        want = srender.render_image(sc, mode="persistent", **kw)
        got = render_image_sharded(sc, mode="persistent", **kw)
        np.testing.assert_array_equal(got, want)
