"""Command-line interface mirroring the reference (src/main.rs:5-79):

    crucible-tpu --file out --world 1 [--movie --seconds S --rate R]

plus extras: --spp/--depth/--width overrides, --seed and --cpu. The output
format follows the --file extension (.ppm, or .png). ``--threads`` is
accepted for parity and ignored (parallelism is the device's, not host
threads').
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="crucible-tpu",
        description="Differentiable Monte Carlo path tracer",
    )
    p.add_argument("--file", required=True, help="output file (extension auto-appended)")
    p.add_argument("--world", type=int, default=1, help="demo world number (invalid -> default with warning)")
    p.add_argument("--threads", type=int, default=None, help="accepted for reference parity; ignored")
    p.add_argument("--movie", action="store_true", help="render a movie world")
    p.add_argument("--seconds", type=float, default=None, help="movie duration (required with --movie)")
    p.add_argument("--rate", type=float, default=None, help="movie frame rate (required with --movie)")
    p.add_argument("--spp", type=int, default=None, help="override samples per pixel")
    p.add_argument("--depth", type=int, default=None, help="override max bounce depth")
    p.add_argument("--width", type=int, default=None, help="override image width")
    p.add_argument("--seed", type=int, default=0, help="render seed")
    p.add_argument("--cpu", action="store_true", help="force the JAX CPU backend")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from crucible_tpu.models import demo, render
    from crucible_tpu.utils import backend

    backend.configure_compile_cache()

    if args.movie:
        if args.seconds is None or args.rate is None:
            print("--movie requires --seconds and --rate", file=sys.stderr)
            return 2
        worlds = demo.MOVIE_WORLDS
        if args.world not in worlds:
            print(f"world {args.world} is invalid, using the default movie", file=sys.stderr)
        fn = worlds.get(args.world, demo.first_movie)
        scene = fn(frame_rate=args.rate, duration=args.seconds)
        if args.width is not None:
            scene.scene_cam.image_width = args.width
    else:
        worlds = demo.WORLDS
        if args.world not in worlds:
            print(f"world {args.world} is invalid, using the default world", file=sys.stderr)
        fn = worlds.get(args.world, demo.book1_end_scene)
        kwargs = {}
        if args.width is not None:
            kwargs["width"] = args.width
        scene = fn(**kwargs)

    scene.seed = args.seed
    if args.spp is not None:
        scene.scene_cam.set_samples(args.spp)
    if args.depth is not None:
        scene.scene_cam.set_max_depth(args.depth)

    scene.render_scene(args.file)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
