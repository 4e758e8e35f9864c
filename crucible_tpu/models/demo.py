"""Demo scene zoo — the canonical workloads of the reference
(src/demo_builder/demo_images.rs, demo_movies.rs), reproduced scene-for-scene.

The reference seeds its random-spheres scene from an unseeded thread-local
RNG (so every run differs, src/demo_builder/demo_images.rs:44); here scene
generation takes an explicit seed for reproducible benchmarks and tests.
"""

from __future__ import annotations

import numpy as np

from crucible_tpu.models.scene import (
    CheckerTexture,
    Dielectric,
    ImageTexture,
    Lambertian,
    Metal,
    Scene,
    Sphere,
)

_CHECKER_GROUND = CheckerTexture.from_colors(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))


def book1_end_scene(width: int = 400, seed: int = 7) -> Scene:
    """"Ray Tracing in One Weekend" final scene (~480 random small spheres +
    3 unit spheres + checker ground). Mirrors demo_images.rs:14-109:
    16:9, 500 spp, depth 50, vfov 20, defocus 0.6deg/10.0, lambertian/metal/
    glass chosen at 0.8/0.15/0.05."""
    sc = Scene.new_image(16.0 / 9.0, width, 24, 180.0)
    cam = sc.scene_cam
    cam.set_samples(500)
    cam.set_max_depth(50)
    cam.look_from((13.0, 2.0, 3.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(20.0)
    cam.set_defocus_angle(0.6)
    cam.set_focus_dist(10.0)

    sc.add_element(
        Sphere((0.0, -1000.0, 0.0), 1000.0, Lambertian.from_texture(_CHECKER_GROUND)),
        "ground",
    )

    rng = np.random.default_rng(seed)
    counter = 0
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose_mat = rng.random()
            center = (
                a + 0.9 * rng.random(),
                0.2,
                b + 0.9 * rng.random(),
            )
            if np.linalg.norm(np.subtract(center, (4.0, 0.2, 0.0))) > 0.9:
                if choose_mat < 0.8:
                    albedo = tuple(rng.random(3) * rng.random(3))
                    material = Lambertian.from_color(albedo)
                elif choose_mat < 0.95:
                    albedo = tuple(rng.uniform(0.5, 1.0, 3))
                    material = Metal(albedo, float(rng.uniform(0.0, 0.5)))
                else:
                    material = Dielectric(1.5)
                sc.add_element(Sphere(center, 0.2, material), f"small{counter}")
                counter += 1

    sc.add_element(Sphere((0.0, 1.0, 0.0), 1.0, Dielectric(1.5)), "large_dielectric")
    sc.add_element(
        Sphere((-4.0, 1.0, 0.0), 1.0, Lambertian.from_color((0.4, 0.2, 0.1))),
        "large_lambertian",
    )
    sc.add_element(
        Sphere((4.0, 1.0, 0.0), 1.0, Metal((0.7, 0.6, 0.5), 0.0)), "large_metal"
    )
    return sc


def checkered_spheres(width: int = 400) -> Scene:
    """Two r=10 checker spheres (demo_images.rs:112-152)."""
    sc = Scene.new_image(16.0 / 9.0, width, 24, 180.0)
    cam = sc.scene_cam
    cam.set_samples(500)
    cam.set_max_depth(50)
    cam.look_from((13.0, 2.0, 3.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(20.0)
    cam.set_defocus_angle(0.6)
    cam.set_focus_dist(10.0)

    mat = Lambertian.from_texture(_CHECKER_GROUND)
    sc.add_element(Sphere((0.0, -10.0, 0.0), 10.0, mat), "bottom_sphere")
    sc.add_element(Sphere((0.0, 10.0, 0.0), 10.0, mat), "top_sphere")
    return sc


def load_teapot(width: int = 400) -> Scene:
    """teapot.obj at 0.5 scale under a metal material + checker ground
    (demo_images.rs:155-200)."""
    sc = Scene.new_image(16.0 / 9.0, width, 24, 180.0)
    cam = sc.scene_cam
    cam.set_samples(200)
    cam.set_max_depth(50)
    cam.look_from((13.0, 10.0, 3.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(20.0)
    cam.set_defocus_angle(0.6)
    cam.set_focus_dist(10.0)

    sc.load_asset("teapot.obj", "teapot", 0.5, (0.0, 0.0, 0.0), Metal((0.8, 0.3, 0.5), 0.05))
    sc.add_element(
        Sphere((0.0, -1000.0, 0.0), 1000.0, Lambertian.from_texture(_CHECKER_GROUND)),
        "ground",
    )
    return sc


def earth(width: int = 400) -> Scene:
    """earthmap.jpg on an r=2 sphere (demo_images.rs:202-221)."""
    sc = Scene.new_image(16.0 / 9.0, width, 24, 180.0)
    cam = sc.scene_cam
    cam.set_samples(500)
    cam.set_max_depth(50)
    cam.look_from((0.0, 0.0, 12.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(20.0)

    sc.add_element(
        Sphere((0.0, 0.0, 0.0), 2.0, Lambertian.from_texture(ImageTexture("earthmap.jpg"))),
        "earth",
    )
    return sc


def garden_skybox(width: int = 1920) -> Scene:
    """Metal ball + garden.hdr spherical skybox (demo_images.rs:223-242).

    The reference repo ships no garden.hdr (SURVEY.md §2.5); a procedural
    substitute is generated into assets/ on demand (io/procedural.py).
    """
    from crucible_tpu.io.procedural import ensure_garden_hdr

    ensure_garden_hdr()
    sc = Scene.new_image(16.0 / 9.0, width, 24, 180.0)
    cam = sc.scene_cam
    cam.set_samples(500)
    cam.set_max_depth(50)
    cam.look_from((0.0, 0.0, -12.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(40.0)

    sc.add_element(Sphere((0.0, 0.0, 0.0), 2.0, Metal((0.8, 0.8, 0.8), 0.05)), "metal_ball")
    sc.load_spherical_skybox("garden.hdr")
    return sc


def nested_checkers(width: int = 400, nest: int = 3) -> Scene:
    """checkered_spheres with a ``nest``-level checker (checker-of-checker-
    of-...): exercises the record schedule's full textures.value resolution
    at real nesting depth (VERDICT r3 weak #6 — previously only the demo
    zoo's single level was measured). Each level has its own inv_scale."""
    from crucible_tpu.models.scene import CheckerTexture, SolidColor

    tex = SolidColor((0.9, 0.9, 0.2))
    other = SolidColor((0.2, 0.3, 0.1))
    scale = 0.08
    for _ in range(nest):
        tex = CheckerTexture(scale, tex, other)
        scale *= 3.7
    sc = Scene.new_image(16.0 / 9.0, width, 24, 180.0)
    cam = sc.scene_cam
    cam.set_samples(100)
    cam.set_max_depth(50)
    cam.look_from((13.0, 2.0, 3.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(20.0)
    sc.add_element(Sphere((0.0, -10.0, 0.0), 10.0, Lambertian(tex)), "bottom")
    sc.add_element(Sphere((0.0, 10.0, 0.0), 10.0, Lambertian(tex)), "top")
    return sc


def sphere_stress(width: int = 400, copies: int = 4, seed: int = 7) -> Scene:
    """book1's random-sphere field tiled ``copies`` times across a grid —
    the multi-tile sphere-table stress scene (VERDICT r3 #5). Each copy is
    a fresh 22x22 random field offset by a grid cell, so the sphere table
    has N ~ 484 * copies rows and most spheres are far from most rays: the
    scenario where a sphere acceleration structure would win.
    Camera/quality settings match book1 (demo_images.rs:14-26)."""
    sc = book1_end_scene(width=width, seed=seed)
    rng = np.random.default_rng(seed + 1)
    counter = 0
    side = int(np.ceil(np.sqrt(max(copies - 1, 0))))
    offsets = []
    for gx in range(-side, side + 1):
        for gz in range(-side, side + 1):
            if (gx, gz) != (0, 0):
                offsets.append((gx * 23.0, gz * 23.0))
    offsets.sort(key=lambda o: abs(o[0]) + abs(o[1]))
    for dx, dz in offsets[: max(copies - 1, 0)]:
        for a in range(-11, 11):
            for b in range(-11, 11):
                choose_mat = rng.random()
                center = (
                    dx + a + 0.9 * rng.random(),
                    0.2,
                    dz + b + 0.9 * rng.random(),
                )
                if choose_mat < 0.8:
                    material = Lambertian.from_color(
                        tuple(rng.random(3) * rng.random(3))
                    )
                elif choose_mat < 0.95:
                    material = Metal(
                        tuple(rng.uniform(0.5, 1.0, 3)),
                        float(rng.uniform(0.0, 0.5)),
                    )
                else:
                    material = Dielectric(1.5)
                sc.add_element(Sphere(center, 0.2, material), f"stress{counter}")
                counter += 1
    return sc


def smoke_scene(width: int = 400) -> Scene:
    """BASELINE config 1: single Lambertian sphere + ground, 16 spp, depth 8 —
    the CPU-runnable smoke test."""
    sc = Scene.new_image(16.0 / 9.0, width, 24, 180.0)
    cam = sc.scene_cam
    cam.set_samples(16)
    cam.set_max_depth(8)
    cam.look_from((0.0, 0.5, 3.0))
    cam.look_at((0.0, 0.0, -1.0))
    cam.set_vfov(60.0)

    sc.add_element(
        Sphere((0.0, 0.0, -1.0), 0.5, Lambertian.from_color((0.7, 0.3, 0.3))), "ball"
    )
    sc.add_element(
        Sphere((0.0, -100.5, -1.0), 100.0, Lambertian.from_color((0.8, 0.8, 0.0))),
        "ground",
    )
    return sc


def first_movie(frame_rate: float = 24.0, duration: float = 15.0) -> Scene:
    """Camera square-walk around a metal ball under the garden skybox, 50 spp,
    depth 5 (demo_movies.rs:12-71). Camera keyframes are wired to the
    timeline animator (models/timeline.py)."""
    from crucible_tpu.io.procedural import ensure_garden_hdr
    from crucible_tpu.models.timeline import LERP, WORLD

    ensure_garden_hdr()
    sc = Scene.new_movie(16.0 / 9.0, 400, frame_rate, 180.0, duration)
    cam = sc.scene_cam
    cam.set_samples(50)
    cam.set_max_depth(5)
    cam.look_from((0.0, 0.0, -12.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(40.0)

    sc.add_element(Sphere((0.0, 0.0, 0.0), 2.0, Metal((0.8, 0.8, 0.8), 0.05)), "metal_ball")
    sc.load_spherical_skybox("garden.hdr")

    sc.cam_translate_point((12.0, 0.0, 0.0), 2.5, LERP, WORLD, "from")
    sc.cam_translate_point((0.0, 0.0, 12.0), 5.0, LERP, WORLD, "from")
    sc.cam_translate_point((-12.0, 0.0, 0.0), 7.5, LERP, WORLD, "from")
    sc.cam_translate_point((0.0, 0.0, -12.0), 10.0, LERP, WORLD, "from")
    sc.cam_translate_point((0.0, 5.0, -20.0), 15.0, LERP, WORLD, "from")
    return sc


def moving_teapot(frame_rate: float = 24.0, duration: float = 5.0) -> Scene:
    """Teapot translate + radius-scale movie (demo_movies.rs:73-128).

    NOTE: in the reference this demo panics at scene build — ``scale_r`` on a
    TriangleMesh is rejected by the animator type-check (SURVEY.md §2.9). We
    keep the translate keyframe and substitute a uniform scale, which is what
    the demo visibly intended.
    """
    from crucible_tpu.models.timeline import LERP, LOCAL

    sc = Scene.new_movie(16.0 / 9.0, 400, frame_rate, 180.0, duration)
    cam = sc.scene_cam
    cam.set_samples(50)
    cam.set_max_depth(5)
    cam.look_from((13.0, 10.0, 3.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(20.0)
    cam.set_defocus_angle(0.6)
    cam.set_focus_dist(10.0)

    sc.load_asset("teapot.obj", "teapot", 0.5, (0.0, 0.0, 0.0), Metal((0.8, 0.3, 0.5), 0.05))
    sc.add_element(
        Sphere((0.0, -1000.0, 0.0), 1000.0, Lambertian.from_texture(_CHECKER_GROUND)),
        "ground",
    )
    sc.translate_point((0.0, 5.0, 0.0), 2.5, LERP, LOCAL, "teapot")
    sc.scale_all_uniform(0.5, 3.0, LERP, "teapot")
    return sc


WORLDS = {
    1: book1_end_scene,
    2: checkered_spheres,
    3: load_teapot,
    4: earth,
    5: garden_skybox,
    6: smoke_scene,
    7: nested_checkers,  # r4 additions beyond the reference zoo
    8: sphere_stress,
}

MOVIE_WORLDS = {
    1: first_movie,
    2: moving_teapot,
}
