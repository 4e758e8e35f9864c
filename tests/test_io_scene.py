"""IO + scene-API tests: id vendor anchors (src/scene/id_vendor.rs:51-75),
OBJ parsing (src/asset_loader/obj_loader.rs), PPM and PNG output, the RGBE
HDR codec, and asset resolution."""

import numpy as np
import pytest

from crucible_tpu.io import hdr as hdr_io
from crucible_tpu.io.assets import build_asset_path
from crucible_tpu.io.image import load_image, read_ppm, write_image, write_png, write_ppm
from crucible_tpu.io.obj import load_obj, parse_obj_text
from crucible_tpu.models.scene import IdVendor, Lambertian, Scene, Sphere


class TestIdVendor:
    def test_cam_reserved(self):
        v = IdVendor()
        assert v.alias_lookup("cam") == (0, "camera")

    def test_collision_returns_none(self):
        # id_vendor.rs:51-63 anchor.
        v = IdVendor()
        assert v.vend_id("a", "sphere") == 1
        assert v.vend_id("a", "sphere") is None

    def test_alias_coherence(self):
        v = IdVendor()
        i1 = v.vend_id("x", "sphere")
        i2 = v.vend_id("y", "triangle_mesh")
        assert v.alias_lookup("x") == (i1, "sphere")
        assert v.alias_lookup("y") == (i2, "triangle_mesh")
        assert v.alias_lookup("z") is None


class TestObjLoader:
    def test_parse_v_f(self):
        v, f = parse_obj_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
        assert v.shape == (3, 3) and f.shape == (1, 3)
        np.testing.assert_array_equal(f[0], [0, 1, 2])

    def test_scale_and_shift(self):
        v, _ = parse_obj_text("v 1 2 3\nf 1 1 1\n", scale=2.0, shift=(1, 0, 0))
        np.testing.assert_allclose(v[0], [3.0, 4.0, 6.0])

    def test_quad_face_rejected(self):
        # obj_loader.rs:115-119: triangles only.
        with pytest.raises(ValueError, match="triangulated"):
            parse_obj_text("v 0 0 0\nf 1 1 1 1\n")

    def test_unknown_record_strict(self):
        # obj_loader.rs:77-87 panics on anything but v/f.
        with pytest.raises(ValueError, match="Unsupported"):
            parse_obj_text("vn 0 0 1\n", strict=True)
        v, f = parse_obj_text("vn 0 0 1\nv 0 0 0\nf 1 1 1\n", strict=False)
        assert len(v) == 1

    def test_teapot_loads(self):
        v, f = load_obj("teapot.obj", scale=0.5)
        assert v.shape == (3644, 3)
        assert f.shape == (6320, 3)
        assert f.min() >= 0 and f.max() < 3644


class TestPPM:
    def test_round_trip(self, tmp_path):
        img = np.random.default_rng(0).integers(0, 256, (4, 5, 3), dtype=np.uint8)
        p = tmp_path / "x.ppm"
        write_ppm(p, img)
        np.testing.assert_array_equal(read_ppm(p), img)

    def test_header_format(self, tmp_path):
        p = tmp_path / "x.ppm"
        write_ppm(p, np.zeros((2, 3, 3), np.uint8))
        head = p.read_text().splitlines()[:3]
        assert head == ["P3", "3 2", "255"]  # reference header (camera/mod.rs:285)


def _decode_png(path):
    """Minimal decoder for the writer's own output (8-bit RGB, filter 0)."""
    import struct
    import zlib

    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        assert crc == zlib.crc32(tag + body)
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


class TestPNG:
    @pytest.mark.parametrize("shape", [(1, 1, 3), (4, 5, 3), (27, 48, 3)])
    def test_round_trip(self, tmp_path, shape):
        img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
        p = tmp_path / "x.png"
        write_png(p, img)
        np.testing.assert_array_equal(_decode_png(p), img)

    def test_write_image_dispatches_on_extension(self, tmp_path):
        img = np.full((2, 3, 3), 7, np.uint8)
        write_image(tmp_path / "a.png", img)
        write_image(tmp_path / "a.ppm", img)
        np.testing.assert_array_equal(_decode_png(tmp_path / "a.png"), img)
        np.testing.assert_array_equal(read_ppm(tmp_path / "a.ppm"), img)

    def test_rejects_non_rgb(self, tmp_path):
        with pytest.raises(ValueError, match="H, W, 3"):
            write_png(tmp_path / "x.png", np.zeros((4, 4), np.uint8))

    def test_jpeg_without_pil_names_the_package(self, tmp_path, monkeypatch):
        import sys

        from crucible_tpu.io.image import load_image_path

        p = tmp_path / "x.jpg"
        p.write_bytes(b"\xff\xd8\xff")
        monkeypatch.setitem(sys.modules, "PIL", None)
        with pytest.raises(ImportError, match="Pillow"):
            load_image_path(p)


class TestHDR:
    def test_rgbe_round_trip(self, tmp_path):
        rng = np.random.default_rng(0)
        img = (rng.random((8, 16, 3)) * 100.0).astype(np.float32)
        p = tmp_path / "t.hdr"
        hdr_io.write_hdr(p, img)
        back = hdr_io.read_hdr(p)
        # RGBE shares one exponent across channels: error bound is relative
        # to the per-pixel MAX channel (1/256 mantissa step).
        bound = img.max(axis=-1, keepdims=True) / 128.0 + 1e-4
        assert np.all(np.abs(back - img) <= bound)

    def test_preserves_high_dynamic_range(self, tmp_path):
        # The reference crushes HDR to rgb8 (img_loader.rs:28) — we must not.
        img = np.zeros((4, 8, 3), np.float32)
        img[0, 0] = [500.0, 450.0, 380.0]  # sun-level radiance
        p = tmp_path / "sun.hdr"
        hdr_io.write_hdr(p, img)
        back = hdr_io.read_hdr(p)
        assert back.max() > 400.0

    def test_garden_generation(self):
        from crucible_tpu.io.procedural import ensure_garden_hdr

        path = ensure_garden_hdr()
        img = load_image(str(path.name))
        assert img.shape[1] == 2 * img.shape[0]  # equirect 2:1
        assert img.max() > 10.0  # real HDR sun


class TestAssets:
    def test_reference_asset_fallback(self):
        p = build_asset_path("earthmap.jpg")
        assert p.exists()

    def test_missing_asset_raises(self):
        with pytest.raises(FileNotFoundError):
            build_asset_path("nope_does_not_exist.png")

    def test_earthmap_loads(self):
        img = load_image("earthmap.jpg")
        assert img.ndim == 3 and img.shape[2] == 3
        assert 0.0 <= img.min() and img.max() <= 1.0


class TestSceneAPI:
    def test_render_scene_writes_default_ppm(self, tmp_path):
        sc = Scene.new_image(1.0, 16)
        sc.scene_cam.set_samples(2)
        sc.scene_cam.look_from((0, 0, 2))
        sc.scene_cam.look_at((0, 0, 0))
        sc.add_element(Sphere((0, 0, 0), 0.5, Lambertian.from_color((0.5, 0.5, 0.5))), "s")
        out = tmp_path / "out"
        sc.render_scene(str(out))
        assert (tmp_path / "out.ppm").exists()

    def test_duplicate_alias_raises(self):
        sc = Scene.new_image(1.0, 16)
        sc.add_element(Sphere((0, 0, 0), 0.5, Lambertian.from_color((0.5,) * 3)), "a")
        with pytest.raises(ValueError):
            sc.add_element(Sphere((1, 0, 0), 0.5, Lambertian.from_color((0.5,) * 3)), "a")

    def test_mesh_shares_one_id(self):
        from crucible_tpu.models.scene import Metal, Triangle

        sc = Scene.new_image(1.0, 16)
        sc.load_asset("teapot.obj", "pot", 0.5, (0, 0, 0), Metal((0.5,) * 3, 0.0))
        ids = {e.id for e in sc.elements if isinstance(e, Triangle)}
        assert len(ids) == 1  # one alias/id for the whole mesh (scene/mod.rs:191-230)
