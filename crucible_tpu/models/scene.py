"""Scene: user-facing builder API + the jit-ready SoA ``SceneData`` pytree.

Host side mirrors the reference's ``Scene`` surface (src/scene/mod.rs:75-348):
aliased elements via an id vendor, OBJ asset loading, spherical skyboxes,
show/hide, still/movie rendering. The build step lowers the object list into
flat arrays — the ``Hittables``/``Materials``/``Textures`` enums of the
reference (src/objects/mod.rs:109-153) become integer type ids + parameter
tables, and the per-frame BVH rebuild (src/scene/mod.rs:333) becomes a
host-side flat-BVH construction cached until the scene is mutated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import jax.numpy as jnp
from crucible_tpu.utils.tree import pytree_dataclass, static_field

from crucible_tpu.models import materials as mat_mod
from crucible_tpu.models import textures as tex_mod
from crucible_tpu.models import skybox as sky_mod
from crucible_tpu.models.camera import Camera
from crucible_tpu.ops.bvh import FlatBVH, build_bvh
from crucible_tpu.io.image import load_image
from crucible_tpu.io.obj import load_obj

# Brute-force triangle intersection below this count; BVH above.
BVH_MIN_TRIS = 64
# Sphere-table row padding: keeps table shapes (and so compiled programs)
# stable while spheres are added or hidden one at a time.
SPHERE_PAD = 8
# Triangles per BVH leaf. The staged traversal (ops/traverse.py) unrolls
# this many sequential tests per leaf visit; larger leaves bloat compile.
BVH_LEAF_SIZE = 32


# --------------------------------------------------------------------------
# Host-side texture / material specs (hashable, deduped into tables at build)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class SolidColor:
    """src/textures/solid_color.rs"""

    color: Tuple[float, float, float]


@dataclass(frozen=True)
class ImageTexture:
    """src/textures/image_texture.rs — nearest-neighbor image lookup."""

    filename: str


@dataclass(frozen=True)
class CheckerTexture:
    """src/textures/checker_texture.rs — 3-D checker over two sub-textures.

    Children may be ANY texture, including other checkers, matching the
    reference's ``Arc<Textures>`` composition; nesting depth is static and
    sizes the evaluation unroll (models/textures.py).
    """

    scale: float
    even: "TextureSpec"
    odd: "TextureSpec"

    @classmethod
    def from_colors(cls, scale, c1, c2):
        return cls(scale, SolidColor(tuple(c1)), SolidColor(tuple(c2)))


TextureSpec = Union[SolidColor, CheckerTexture, ImageTexture]


def _as_texture(spec_or_color) -> TextureSpec:
    if isinstance(spec_or_color, (SolidColor, CheckerTexture, ImageTexture)):
        return spec_or_color
    return SolidColor(tuple(float(c) for c in spec_or_color))


@dataclass(frozen=True)
class Lambertian:
    """src/materials/lambertian.rs — textured albedo + Russian-roulette
    scatter probability (1/p compensated)."""

    texture: TextureSpec
    scatter_prob: float = 1.0

    @classmethod
    def from_color(cls, color, prob: float = 1.0):
        return cls(SolidColor(tuple(float(c) for c in color)), prob)

    @classmethod
    def from_texture(cls, tex: TextureSpec, prob: float = 1.0):
        return cls(tex, prob)


@dataclass(frozen=True)
class Metal:
    """src/materials/metal.rs — fuzzy mirror; fuzz must be in [0, 1]."""

    albedo: Tuple[float, float, float]
    fuzz: float = 0.0

    def __post_init__(self):
        assert 0.0 <= self.fuzz <= 1.0, "A metal fuzz factor must be in [0, 1]"


@dataclass(frozen=True)
class Dielectric:
    """src/materials/dielectric.rs — glass/water with Schlick reflectance."""

    refraction_index: float


@dataclass(frozen=True)
class Emissive:
    """Extension beyond the reference: a light-emitting material whose
    radiance gradient is a first-class target (BASELINE.json)."""

    emission: Tuple[float, float, float]


MaterialSpec = Union[Lambertian, Metal, Dielectric, Emissive]


# --------------------------------------------------------------------------
# Host-side geometry elements
# --------------------------------------------------------------------------


@dataclass
class Sphere:
    """Host-side sphere element (src/objects/sphere.rs:15-40)."""

    center: Tuple[float, float, float]
    radius: float
    material: MaterialSpec
    id: int = 0
    hide: bool = False
    timeline: Optional[object] = None  # TransformTimeline (models/timeline.py)

    def __post_init__(self):
        assert self.radius >= 0.0, "Cannot make a sphere with negative radius"


@dataclass
class Triangle:
    """Host-side triangle element (src/objects/triangle.rs:8-34)."""

    v0: Tuple[float, float, float]
    v1: Tuple[float, float, float]
    v2: Tuple[float, float, float]
    material: MaterialSpec
    id: int = 0
    hide: bool = False
    timelines: Optional[tuple] = None  # per-vertex timelines


# --------------------------------------------------------------------------
# Id vendor (src/scene/id_vendor.rs)
# --------------------------------------------------------------------------

CAMERA_TYPE = "camera"
SPHERE_TYPE = "sphere"
TRIANGLE_TYPE = "triangle"
MESH_TYPE = "triangle_mesh"


class IdVendor:
    """Alias -> (id, object type); id 0 reserved for the camera
    (src/scene/id_vendor.rs:15-49)."""

    def __init__(self):
        self._table: Dict[str, Tuple[int, str]] = {"cam": (0, CAMERA_TYPE)}
        self._next = 1

    def vend_id(self, alias: str, o_type: str) -> Optional[int]:
        if alias in self._table:
            return None  # collision
        oid = self._next
        self._next += 1
        self._table[alias] = (oid, o_type)
        return oid

    def alias_lookup(self, alias: str) -> Optional[Tuple[int, str]]:
        return self._table.get(alias)


# --------------------------------------------------------------------------
# Jit-side scene pytree
# --------------------------------------------------------------------------


@pytree_dataclass
class SceneData:
    """Flat SoA scene, ready for the wavefront integrator.

    Data leaves are jnp arrays (differentiable where meaningful); static
    metadata rides as non-pytree fields so jit specializes on scene shape.
    """

    # Spheres (padded to SPHERE_PAD multiples; `sph_active` masks padding+hidden)
    sph_center: jnp.ndarray  # (N, 3)
    sph_radius: jnp.ndarray  # (N,)
    sph_mat: jnp.ndarray  # (N,) int32
    sph_active: jnp.ndarray  # (N,) bool

    # Triangles (leaf order when use_bvh)
    tri_v0: jnp.ndarray  # (M, 3)
    tri_v1: jnp.ndarray
    tri_v2: jnp.ndarray
    tri_mat: jnp.ndarray  # (M,) int32
    tri_active: jnp.ndarray  # (M,) bool

    # Material table
    mat_type: jnp.ndarray  # (L,) int32
    mat_tex: jnp.ndarray  # (L,) int32 albedo texture id
    mat_fuzz: jnp.ndarray  # (L,)
    mat_ior: jnp.ndarray  # (L,)
    mat_prob: jnp.ndarray  # (L,)
    mat_emission: jnp.ndarray  # (L, 3)

    tex: tex_mod.TextureTable

    sky_image: jnp.ndarray  # (H, W, 3); dummy (1,1,3) when sky_kind == DEFAULT

    # Flat BVH over triangles (dummy 1-node arrays when unused)
    bvh_min: jnp.ndarray  # (K, 3)
    bvh_max: jnp.ndarray
    bvh_first: jnp.ndarray  # (K,) int32
    bvh_count: jnp.ndarray
    bvh_miss: jnp.ndarray

    # Linear shutter-motion deltas (None for static scenes): position at the
    # per-ray shutter fraction w is base + w * delta (models/timeline.py).
    sph_center_d: jnp.ndarray = None  # (N, 3)
    sph_radius_d: jnp.ndarray = None  # (N,)
    tri_v0_d: jnp.ndarray = None  # (M, 3)
    tri_v1_d: jnp.ndarray = None
    tri_v2_d: jnp.ndarray = None

    # Exact per-ray-time timeline tracks (None unless motion_exact): set when
    # a keyframe lands INSIDE the shutter window, where the linear-shutter
    # lerp of endpoint snapshots deviates from the reference's per-ray
    # timeline evaluation (timeline/mod.rs:233-263). The integrator then
    # evaluates the piecewise-linear tracks at each ray's absolute time
    # t = motion_t0 + w * (motion_t1 - motion_t0) via timeline.eval_translate
    # / eval_scale. Sphere radius rides scale component 0.
    sph_tr_t0: jnp.ndarray = None  # (N, Kt)
    sph_tr_t1: jnp.ndarray = None
    sph_tr_delta: jnp.ndarray = None  # (N, Kt, 3)
    sph_tr_init: jnp.ndarray = None  # (N, 3)
    sph_sc_t0: jnp.ndarray = None  # (N, Ks)
    sph_sc_t1: jnp.ndarray = None
    sph_sc_from: jnp.ndarray = None  # (N, Ks, 3)
    sph_sc_to: jnp.ndarray = None
    tri_tr_t0: jnp.ndarray = None  # (3M, Kt) — vertex-major [v0 of all tris..]
    tri_tr_t1: jnp.ndarray = None
    tri_tr_delta: jnp.ndarray = None  # (3M, Kt, 3)
    tri_tr_init: jnp.ndarray = None  # (3M, 3)
    tri_sc_t0: jnp.ndarray = None
    tri_sc_t1: jnp.ndarray = None
    tri_sc_from: jnp.ndarray = None
    tri_sc_to: jnp.ndarray = None
    motion_t0: jnp.ndarray = None  # () shutter-open absolute time
    motion_t1: jnp.ndarray = None  # () shutter-close

    # --- static metadata ---------------------------------------------------
    sky_kind: int = static_field(sky_mod.DEFAULT)
    num_spheres: int = static_field(0)
    num_tris: int = static_field(0)
    use_bvh: bool = static_field(False)
    bvh_leaf_size: int = static_field(4)
    animated: bool = static_field(False)
    # Exact per-ray-time evaluation engaged (see track fields above).
    motion_exact: bool = static_field(False)
    # Triangle tracks present (mesh keyframe mid-shutter). Covers both the
    # brute-force path (full (R, M) evaluation) and BVH meshes (per-candidate
    # evaluation in the leaf test; track rows are in LEAF order).
    tri_exact: bool = static_field(False)


def _pad_to(n: int, mult: int) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


class _TableBuilder:
    """Dedupes material/texture specs into SoA tables."""

    def __init__(self):
        self.tex_rows: List[dict] = []
        self.tex_ids: Dict[TextureSpec, int] = {}
        self.images: List[np.ndarray] = []
        self.image_ids: Dict[str, int] = {}
        self.mat_rows: List[dict] = []
        self.mat_ids: Dict[MaterialSpec, int] = {}

    def texture(self, spec: TextureSpec) -> int:
        if spec in self.tex_ids:
            return self.tex_ids[spec]
        if isinstance(spec, SolidColor):
            row = dict(kind=tex_mod.SOLID, color=spec.color, inv_scale=1.0, even=0, odd=0, image=0)
        elif isinstance(spec, ImageTexture):
            if spec.filename not in self.image_ids:
                self.image_ids[spec.filename] = len(self.images)
                self.images.append(load_image(spec.filename))
            row = dict(
                kind=tex_mod.IMAGE,
                color=(1.0, 0.0, 1.0),
                inv_scale=1.0,
                even=0,
                odd=0,
                image=self.image_ids[spec.filename],
            )
        elif isinstance(spec, CheckerTexture):
            even = self.texture(spec.even)
            odd = self.texture(spec.odd)
            row = dict(
                kind=tex_mod.CHECKER,
                color=(0.0, 0.0, 0.0),
                inv_scale=1.0 / spec.scale,
                even=even,
                odd=odd,
                image=0,
            )
        else:
            raise TypeError(f"unknown texture spec {spec!r}")
        tid = len(self.tex_rows)
        self.tex_rows.append(row)
        self.tex_ids[spec] = tid
        return tid

    def material(self, spec: MaterialSpec) -> int:
        if spec in self.mat_ids:
            return self.mat_ids[spec]
        if isinstance(spec, Lambertian):
            row = dict(
                type=mat_mod.LAMBERTIAN,
                tex=self.texture(spec.texture),
                fuzz=0.0,
                ior=1.0,
                prob=spec.scatter_prob,
                emission=(0.0, 0.0, 0.0),
            )
        elif isinstance(spec, Metal):
            row = dict(
                type=mat_mod.METAL,
                tex=self.texture(SolidColor(tuple(spec.albedo))),
                fuzz=spec.fuzz,
                ior=1.0,
                prob=1.0,
                emission=(0.0, 0.0, 0.0),
            )
        elif isinstance(spec, Dielectric):
            row = dict(
                type=mat_mod.DIELECTRIC,
                tex=self.texture(SolidColor((1.0, 1.0, 1.0))),
                fuzz=0.0,
                ior=spec.refraction_index,
                prob=1.0,
                emission=(0.0, 0.0, 0.0),
            )
        elif isinstance(spec, Emissive):
            row = dict(
                type=mat_mod.EMISSIVE,
                tex=self.texture(SolidColor((0.0, 0.0, 0.0))),
                fuzz=0.0,
                ior=1.0,
                prob=1.0,
                emission=tuple(spec.emission),
            )
        else:
            raise TypeError(f"unknown material spec {spec!r}")
        mid = len(self.mat_rows)
        self.mat_rows.append(row)
        self.mat_ids[spec] = mid
        return mid

    def texture_table(self) -> tex_mod.TextureTable:
        rows = self.tex_rows or [
            dict(kind=tex_mod.SOLID, color=(0, 0, 0), inv_scale=1.0, even=0, odd=0, image=0)
        ]

        # Static checker-nesting depth: children are always created BEFORE
        # their parent (texture() recursion), so one forward pass suffices.
        depth = [0] * len(rows)
        for i, r in enumerate(rows):
            if r["kind"] == tex_mod.CHECKER:
                depth[i] = 1 + max(depth[r["even"]], depth[r["odd"]])
        return tex_mod.TextureTable(
            max_nest=max(1, max(depth, default=1)),
            kind=jnp.asarray([r["kind"] for r in rows], jnp.int32),
            color=jnp.asarray([r["color"] for r in rows], jnp.float32),
            inv_scale=jnp.asarray([r["inv_scale"] for r in rows], jnp.float32),
            even=jnp.asarray([r["even"] for r in rows], jnp.int32),
            odd=jnp.asarray([r["odd"] for r in rows], jnp.int32),
            image_id=jnp.asarray([r["image"] for r in rows], jnp.int32),
            images=tuple(jnp.asarray(im, jnp.float32) for im in self.images),
        )


class Scene:
    """User-facing scene builder (reference Scene, src/scene/mod.rs:75-348)."""

    def __init__(
        self,
        aspect_ratio: float = 16.0 / 9.0,
        image_width: int = 400,
        frame_rate: float = 24.0,
        shutter_angle: float = 180.0,
        duration: Optional[float] = None,
        seed: int = 0,
    ):
        self.scene_cam = Camera(
            aspect_ratio=aspect_ratio,
            image_width=image_width,
            frame_rate=frame_rate,
            shutter_angle=shutter_angle,
        )
        self.elements: List[Union[Sphere, Triangle]] = []
        self.sky_kind: int = sky_mod.DEFAULT
        self.sky_image: Optional[np.ndarray] = None
        self.id_vendor = IdVendor()
        self.duration = duration
        self.frame_rate = frame_rate
        self.seed = seed
        self._cache: Optional[SceneData] = None
        self._cache_key = None

    # --- constructors mirroring the reference ------------------------------
    @classmethod
    def new_image(cls, aspect_ratio, image_width, frame_rate=24.0, shutter_angle=180.0, threads=None):
        del threads  # parallelism is the device's, not host threads'
        return cls(aspect_ratio, image_width, frame_rate, shutter_angle, None)

    @classmethod
    def new_movie(cls, aspect_ratio, image_width, frame_rate, shutter_angle, duration, threads=None):
        del threads
        return cls(aspect_ratio, image_width, frame_rate, shutter_angle, duration)

    # --- element management -------------------------------------------------
    def add_element(self, element: Union[Sphere, Triangle], alias: str) -> int:
        """Vend a unique id for ``alias`` and add the element
        (src/scene/mod.rs:159-188). Raises on alias collision."""
        o_type = SPHERE_TYPE if isinstance(element, Sphere) else TRIANGLE_TYPE
        oid = self.id_vendor.vend_id(alias, o_type)
        if oid is None:
            raise ValueError(f"alias {alias!r} already exists in scene")
        element.id = oid
        self.elements.append(element)
        self._cache = None
        return oid

    def load_asset(self, filename: str, alias: str, scale: float, shift, material: MaterialSpec) -> int:
        """Load an OBJ mesh under a single alias/id; triangles are flattened
        into the element list sharing that id (src/scene/mod.rs:191-230)."""
        oid = self.id_vendor.vend_id(alias, MESH_TYPE)
        if oid is None:
            raise ValueError(f"alias {alias!r} already exists in scene")
        verts, faces = load_obj(filename, scale=scale, shift=tuple(shift))
        for f in faces:
            self.elements.append(
                Triangle(
                    tuple(verts[f[0]]),
                    tuple(verts[f[1]]),
                    tuple(verts[f[2]]),
                    material,
                    id=oid,
                )
            )
        self._cache = None
        return oid

    def load_spherical_skybox(self, filename: str) -> None:
        """src/scene/mod.rs — spherical equirect skybox from an image (full
        float HDR supported, unlike the reference's rgb8 crush)."""
        self.sky_image = load_image(filename)
        self.sky_kind = sky_mod.SPHERICAL
        self._cache = None

    def _set_hidden(self, alias: str, hide: bool) -> None:
        info = self.id_vendor.alias_lookup(alias)
        if info is None:
            raise KeyError(f"unknown alias {alias!r}")
        oid, _ = info
        for el in self.elements:
            if el.id == oid:
                el.hide = hide
        self._cache = None

    def hide_element(self, alias: str) -> None:
        self._set_hidden(alias, True)

    def show_element(self, alias: str) -> None:
        self._set_hidden(alias, False)

    # --- animation (src/scene/scene_animator.rs surface) --------------------
    def _check_alias(self, alias: str, invalid_types) -> int:
        """Alias lookup + object type check (scene_animator.rs:13-31)."""
        info = self.id_vendor.alias_lookup(alias)
        if info is None:
            raise KeyError(f"unknown alias {alias!r}")
        oid, o_type = info
        if o_type in invalid_types:
            raise TypeError(f"animation not valid for object type {o_type!r} ({alias!r})")
        return oid

    def _element_timelines(self, oid: int):
        """Yield (timeline, kind) pairs for every matching element, creating
        timelines on demand. Triangles get one timeline per VERTEX like the
        reference (src/objects/triangle.rs:15-17)."""
        from crucible_tpu.models.timeline import TransformTimeline

        out = []
        for el in self.elements:
            if el.id != oid:
                continue
            if isinstance(el, Sphere):
                if el.timeline is None:
                    el.timeline = TransformTimeline(
                        init_pos=tuple(el.center), init_scale=float(el.radius)
                    )
                out.append(el.timeline)
            else:
                if el.timelines is None:
                    el.timelines = (
                        TransformTimeline(init_pos=tuple(el.v0), init_scale=1.0),
                        TransformTimeline(init_pos=tuple(el.v1), init_scale=1.0),
                        TransformTimeline(init_pos=tuple(el.v2), init_scale=1.0),
                    )
                out.extend(el.timelines)
        self._cache = None
        return out

    def translate_x(self, x, keyframe, interp, space, alias):
        oid = self._check_alias(alias, [CAMERA_TYPE])
        for tl in self._element_timelines(oid):
            tl.translate_x(x, keyframe, interp, space)

    def translate_y(self, y, keyframe, interp, space, alias):
        oid = self._check_alias(alias, [CAMERA_TYPE])
        for tl in self._element_timelines(oid):
            tl.translate_y(y, keyframe, interp, space)

    def translate_z(self, z, keyframe, interp, space, alias):
        oid = self._check_alias(alias, [CAMERA_TYPE])
        for tl in self._element_timelines(oid):
            tl.translate_z(z, keyframe, interp, space)

    def translate_point(self, p, keyframe, interp, space, alias):
        oid = self._check_alias(alias, [CAMERA_TYPE])
        for tl in self._element_timelines(oid):
            tl.translate_point(p, keyframe, interp, space)

    def scale_r(self, r, keyframe, interp, alias):
        """Sphere radius keyframe — spheres only
        (scene_animator.rs:140-173 rejects meshes/triangles)."""
        oid = self._check_alias(alias, [CAMERA_TYPE, MESH_TYPE, TRIANGLE_TYPE])
        for tl in self._element_timelines(oid):
            tl.scale_r(r, keyframe, interp)

    def scale_x(self, f, keyframe, interp, alias):
        """Per-axis scale — triangles/meshes only
        (scene_animator.rs:38-134 rejects spheres). The reference's scale_y
        m21 shear defect is NOT replicated (SURVEY.md §2.6)."""
        oid = self._check_alias(alias, [CAMERA_TYPE, SPHERE_TYPE])
        for tl in self._element_timelines(oid):
            tl.scale_x(f, keyframe, interp)

    def scale_y(self, f, keyframe, interp, alias):
        oid = self._check_alias(alias, [CAMERA_TYPE, SPHERE_TYPE])
        for tl in self._element_timelines(oid):
            tl.scale_y(f, keyframe, interp)

    def scale_z(self, f, keyframe, interp, alias):
        oid = self._check_alias(alias, [CAMERA_TYPE, SPHERE_TYPE])
        for tl in self._element_timelines(oid):
            tl.scale_z(f, keyframe, interp)

    def scale_point(self, p, keyframe, interp, alias):
        """Vector-valued scale keyframe. One key (not three sibling
        transforms whose most-recent-wins keeps only Z, as in the
        reference's composite — documented fix, models/timeline.py)."""
        oid = self._check_alias(alias, [CAMERA_TYPE, SPHERE_TYPE])
        for tl in self._element_timelines(oid):
            tl.scale_x(p[0], keyframe, interp)
            tl.scale_y(p[1], keyframe, interp)
            tl.scale_z(p[2], keyframe, interp)

    def scale_all_uniform(self, f, keyframe, interp, alias):
        oid = self._check_alias(alias, [CAMERA_TYPE, SPHERE_TYPE])
        for tl in self._element_timelines(oid):
            tl.scale_uniform(f, keyframe, interp)

    def _cam_timeline(self, which: str):
        from crucible_tpu.models.timeline import TransformTimeline

        cam = self.scene_cam
        if which == "from":
            if cam.from_timeline is None:
                cam.from_timeline = TransformTimeline(init_pos=cam.look_from_pt)
            return cam.from_timeline
        if which == "at":
            if cam.at_timeline is None:
                cam.at_timeline = TransformTimeline(init_pos=cam.look_at_pt)
            return cam.at_timeline
        raise KeyError(f"camera animation target must be 'from' or 'at', got {which!r}")

    def cam_translate_x(self, x, keyframe, interp, space, which):
        self._cam_timeline(which).translate_x(x, keyframe, interp, space)

    def cam_translate_y(self, y, keyframe, interp, space, which):
        self._cam_timeline(which).translate_y(y, keyframe, interp, space)

    def cam_translate_z(self, z, keyframe, interp, space, which):
        self._cam_timeline(which).translate_z(z, keyframe, interp, space)

    def cam_translate_point(self, p, keyframe, interp, space, which):
        self._cam_timeline(which).translate_point(p, keyframe, interp, space)

    @property
    def is_animated(self) -> bool:
        return any(
            (isinstance(e, Sphere) and e.timeline is not None and e.timeline.animated)
            or (
                isinstance(e, Triangle)
                and e.timelines is not None
                and any(t.animated for t in e.timelines)
            )
            for e in self.elements
        )

    # --- lowering -----------------------------------------------------------
    def build(self, t_open: float | None = None, t_close: float | None = None, leaf_size: int | None = None, bvh_method: str = "sah") -> SceneData:
        """Lower the element list to a SceneData pytree (cached per shutter
        window until the scene is mutated).

        For animated scenes, geometry is host-evaluated at shutter open and
        close; the integrator lerps per ray (linear-shutter motion model,
        models/timeline.py). The reference instead rebuilds its BVH every
        frame and re-evaluates timelines per ray (src/scene/mod.rs:333).

        ``leaf_size=None`` uses :data:`BVH_LEAF_SIZE`.

        ``bvh_method="sah"`` (default) uses the binned surface-area-heuristic
        split with leaf-size snapping; ``"median"`` reproduces the
        reference's sort + median-count topology (bvhwrapper.rs:46-80).
        Both run through the native C++ builder (crucible_tpu/native) with
        a NumPy fallback, so large meshes build at C++ speed either way
        (ADVICE r2: the SAH default previously bypassed the native path).

        BVH children are post-ordered near-first along the camera view axis
        at build time (ops/bvh.py::reorder_front_to_back). The ordering is
        a traversal-perf heuristic only — any child order renders the same
        image — so a camera that moves WITHOUT dirtying the scene cache
        merely keeps a stale (still valid) order.
        """
        if leaf_size is None:
            leaf_size = BVH_LEAF_SIZE
        animated = self.is_animated
        if animated and t_open is None:
            t_open, t_close = self.scene_cam.shutter_window()
        key = ((t_open, t_close) if animated else None, leaf_size, bvh_method)
        if self._cache is not None and self._cache_key == key:
            return self._cache

        def _mid_shutter(tl) -> bool:
            """A segment boundary strictly inside the shutter window means
            the trajectory changes slope mid-shutter — the linear lowering
            would deviate from per-ray timeline evaluation."""
            b = tl.boundary_times()
            return bool(np.any((b > t_open + 1e-9) & (b < t_close - 1e-9)))

        sphere_exact = animated and any(
            isinstance(e, Sphere) and e.timeline is not None and _mid_shutter(e.timeline)
            for e in self.elements
        )
        tri_mid = animated and any(
            isinstance(e, Triangle)
            and e.timelines is not None
            and any(_mid_shutter(t) for t in e.timelines)
            for e in self.elements
        )

        def sphere_geom(s: Sphere):
            if animated and s.timeline is not None:
                ca = s.timeline.position_at(t_open)
                cb = s.timeline.position_at(t_close)
                ra = float(s.timeline.scale_at(t_open)[0])
                rb = float(s.timeline.scale_at(t_close)[0])
                return ca, cb, ra, rb
            return s.center, s.center, s.radius, s.radius

        tables = _TableBuilder()
        spheres = [e for e in self.elements if isinstance(e, Sphere)]
        tris = [e for e in self.elements if isinstance(e, Triangle)]

        n = len(spheres)
        n_pad = _pad_to(n, SPHERE_PAD)
        sph_center = np.zeros((n_pad, 3), np.float32)
        sph_center_b = np.zeros((n_pad, 3), np.float32)
        sph_radius = np.ones((n_pad,), np.float32)
        sph_radius_b = np.ones((n_pad,), np.float32)
        sph_mat = np.zeros((n_pad,), np.int32)
        sph_active = np.zeros((n_pad,), bool)
        for k, s in enumerate(spheres):
            ca, cb, ra, rb = sphere_geom(s)
            sph_center[k] = ca
            sph_center_b[k] = cb
            sph_radius[k] = ra
            sph_radius_b[k] = rb
            sph_mat[k] = tables.material(s.material)
            sph_active[k] = not s.hide

        # Hidden triangles are filtered before BVH build, like the reference
        # (src/objects/bvhwrapper.rs:16-27).
        vis_tris = [t for t in tris if not t.hide]
        m = len(vis_tris)
        use_bvh = m > BVH_MIN_TRIS
        va_b = vb_b = None
        if m:
            anim_idx = [
                i for i, t in enumerate(vis_tris)
                if animated and t.timelines is not None
            ]
            va = np.asarray(
                [[t.v0, t.v1, t.v2] for t in vis_tris], np.float32
            )  # (m, 3verts, 3)
            if anim_idx:
                # BATCH-evaluate all animated vertex timelines at shutter
                # open/close with the vectorized NumPy track evaluators —
                # per-vertex Python evaluation (tri_geom) cost ~2.2 s per
                # movie frame on the 6,320-tri teapot (37,920 scalar
                # timeline evals); this path is ~50x cheaper and the
                # lowering itself is memoized on each timeline.
                from crucible_tpu.models import timeline as tl_mod

                tls = [tl for i in anim_idx for tl in vis_tris[i].timelines]
                p0, p1, pd = tl_mod.pad_tracks(
                    [tl.lower_translate() for tl in tls]
                )
                s0, s1, sf, sg = tl_mod.pad_scale_tracks(
                    [tl.lower_scale() for tl in tls]
                )
                init = np.asarray([tl.init_pos for tl in tls], np.float64)
                vb = va.copy()
                pa = (
                    tl_mod.eval_scale_np(s0, s1, sf, sg, t_open)
                    * tl_mod.eval_translate_np(p0, p1, pd, init, t_open)
                )
                pb = (
                    tl_mod.eval_scale_np(s0, s1, sf, sg, t_close)
                    * tl_mod.eval_translate_np(p0, p1, pd, init, t_close)
                )
                va[anim_idx] = pa.reshape(-1, 3, 3).astype(np.float32)
                vb[anim_idx] = pb.reshape(-1, 3, 3).astype(np.float32)
            else:
                vb = va
            v0, v1, v2 = va[:, 0], va[:, 1], va[:, 2]
            v0b, v1b, v2b = vb[:, 0], vb[:, 1], vb[:, 2]
            t_mat = np.asarray([tables.material(t.material) for t in vis_tris], np.int32)
            if use_bvh:
                # Union of shutter-open and shutter-close bounds so moving
                # primitives stay enclosed (refit fixes the reference's
                # stale-inner-node problem, SURVEY.md §2.2).
                lo = np.minimum(va.min(axis=1), vb.min(axis=1))
                hi = np.maximum(va.max(axis=1), vb.max(axis=1))
                if tri_mid:
                    # Mid-shutter keyframes: the piecewise-linear trajectory
                    # kinks INSIDE the window, so endpoint snapshots do not
                    # enclose it. Union bounds over every interior segment
                    # boundary — piecewise-linear extrema live at the kinks,
                    # so this encloses the exact trajectory the per-ray leaf
                    # test (ops/traverse.py vertex_fn) will evaluate.
                    bts = set()
                    for t in vis_tris:
                        if t.timelines is not None:
                            for tl in t.timelines:
                                b = tl.boundary_times()
                                bts.update(
                                    float(x)
                                    for x in b[(b > t_open) & (b < t_close)]
                                )
                    for bt in sorted(bts):
                        vt = []
                        for t in vis_tris:
                            if t.timelines is not None:
                                vt.append(
                                    [
                                        tl.scale_at(bt) * tl.position_at(bt)
                                        for tl in t.timelines
                                    ]
                                )
                            else:
                                vt.append([t.v0, t.v1, t.v2])
                        vt = np.asarray(vt, np.float32)  # (m, 3, 3)
                        lo = np.minimum(lo, vt.min(axis=1))
                        hi = np.maximum(hi, vt.max(axis=1))
                bvh = build_bvh(lo, hi, leaf_size=leaf_size, method=bvh_method)
                # Near-first child order along the camera view axis: the
                # skip-link DFS then visits leaves roughly front-to-back
                # for primary rays, tightening best-t earlier (~26% fewer
                # union-leaf visits on the teapot, tools/walk_sim.py).
                cam = self.scene_cam
                t0_cam = cam.shutter_window()[0]
                cam_from = (
                    cam.from_timeline.position_at(t0_cam)
                    if cam.from_timeline is not None
                    else cam.look_from_pt
                )
                cam_at = (
                    cam.at_timeline.position_at(t0_cam)
                    if cam.at_timeline is not None
                    else cam.look_at_pt
                )
                view = np.asarray(cam_at, np.float64) - np.asarray(
                    cam_from, np.float64
                )
                if np.linalg.norm(view) > 1e-12:
                    from crucible_tpu.ops.bvh import reorder_front_to_back

                    bvh = reorder_front_to_back(bvh, view)
                perm = bvh.perm
                v0, v1, v2, t_mat = v0[perm], v1[perm], v2[perm], t_mat[perm]
                v0b, v1b, v2b = v0b[perm], v1b[perm], v2b[perm]
                t_active = np.ones((m,), bool)
            else:
                bvh = None
                m_pad = _pad_to(m, 8)
                pad = m_pad - m
                v0, v1, v2, v0b, v1b, v2b = (
                    np.pad(a, ((0, pad), (0, 0))) for a in (v0, v1, v2, v0b, v1b, v2b)
                )
                t_mat = np.pad(t_mat, (0, pad))
                t_active = np.zeros((m_pad,), bool)
                t_active[:m] = True
            va_b = (v0b, v1b, v2b)
        else:
            bvh = None
            v0 = v1 = v2 = np.zeros((1, 3), np.float32)
            t_mat = np.zeros((1,), np.int32)
            t_active = np.zeros((1,), bool)

        if bvh is None:
            bvh = FlatBVH(
                node_min=np.zeros((1, 3), np.float32),
                node_max=np.zeros((1, 3), np.float32),
                node_first=np.zeros((1,), np.int32),
                node_count=np.zeros((1,), np.int32),
                node_miss=np.ones((1,), np.int32),
                node_parent=np.full((1,), -1, np.int32),
                perm=np.zeros((0,), np.int32),
            )

        # --- exact per-ray-time tracks (mid-shutter keyframes) --------------
        # BVH meshes included (r4): leaf tests evaluate per-candidate vertex
        # timelines at the ray's time (ops/traverse.py vertex_fn), with node
        # bounds unioned over keyframe breakpoints above — the wavefront analogue
        # of the reference evaluating timelines per ray through traversal
        # (src/objects/bvhwrapper.rs:102-106).
        tri_exact = tri_mid
        motion_exact = sphere_exact or tri_exact
        track_fields = {}
        if motion_exact:
            import sys

            from crucible_tpu.models import timeline as tl_mod

            print(
                "crucible_tpu: keyframe inside the shutter window -> exact "
                "per-ray timeline evaluation engaged (replay gradients "
                "re-derive the exact tracks per winner)",
                file=sys.stderr,
            )

            def _tl_of(el):
                if isinstance(el, Sphere):
                    return el.timeline or tl_mod.TransformTimeline(
                        init_pos=tuple(el.center), init_scale=float(el.radius)
                    )
                raise TypeError(el)

            s_tr, s_sc, s_init = [], [], []
            for s in spheres:
                tl = _tl_of(s)
                s_tr.append(tl.lower_translate())
                s_sc.append(tl.lower_scale())
                s_init.append(tl.init_pos)
            empty_tr = (
                np.zeros((0,), np.float32),
                np.zeros((0,), np.float32),
                np.zeros((0, 3), np.float32),
            )
            empty_sc = tl_mod.TransformTimeline().lower_scale()
            while len(s_tr) < n_pad:
                s_tr.append(empty_tr)
                s_sc.append(empty_sc)
                s_init.append((0.0, 0.0, 0.0))
            a0, a1, adel = tl_mod.pad_tracks(s_tr)
            b0, b1, bf, bt = tl_mod.pad_scale_tracks(s_sc)
            track_fields.update(
                sph_tr_t0=jnp.asarray(a0),
                sph_tr_t1=jnp.asarray(a1),
                sph_tr_delta=jnp.asarray(adel),
                sph_tr_init=jnp.asarray(np.asarray(s_init, np.float32)),
                sph_sc_t0=jnp.asarray(b0),
                sph_sc_t1=jnp.asarray(b1),
                sph_sc_from=jnp.asarray(bf),
                sph_sc_to=jnp.asarray(bt),
            )
            if tri_exact and m:
                m_rows = v0.shape[0]  # padded (brute-force) or leaf-order count
                # Track rows must align with the lowered vertex arrays: BVH
                # meshes are permuted into leaf order.
                src_tris = (
                    [vis_tris[j] for j in perm] if use_bvh else vis_tris
                )
                t_tr, t_sc, t_init = [], [], []
                # Vertex-major: rows [vi*m_rows + k] = vertex vi of tri k.
                for vi in range(3):
                    for k in range(m_rows):
                        if k < m and src_tris[k].timelines is not None:
                            tl = src_tris[k].timelines[vi]
                        else:
                            base = (v0, v1, v2)[vi][k]
                            tl = tl_mod.TransformTimeline(
                                init_pos=tuple(float(x) for x in base)
                            )
                        t_tr.append(tl.lower_translate())
                        t_sc.append(tl.lower_scale())
                        t_init.append(tl.init_pos)
                c0, c1, cdel = tl_mod.pad_tracks(t_tr)
                d0, d1, df, dt = tl_mod.pad_scale_tracks(t_sc)
                track_fields.update(
                    tri_tr_t0=jnp.asarray(c0),
                    tri_tr_t1=jnp.asarray(c1),
                    tri_tr_delta=jnp.asarray(cdel),
                    tri_tr_init=jnp.asarray(np.asarray(t_init, np.float32)),
                    tri_sc_t0=jnp.asarray(d0),
                    tri_sc_t1=jnp.asarray(d1),
                    tri_sc_from=jnp.asarray(df),
                    tri_sc_to=jnp.asarray(dt),
                )
            track_fields.update(
                motion_t0=jnp.asarray(t_open, jnp.float32),
                motion_t1=jnp.asarray(t_close, jnp.float32),
            )

        if not tables.mat_rows:  # empty scene still needs one material row
            tables.material(Lambertian.from_color((0.5, 0.5, 0.5)))

        mat_rows = tables.mat_rows
        sky_img = (
            jnp.asarray(self.sky_image, jnp.float32)
            if self.sky_image is not None
            else jnp.zeros((1, 1, 3), jnp.float32)
        )

        sd = SceneData(
            sph_center=jnp.asarray(sph_center),
            sph_radius=jnp.asarray(sph_radius),
            sph_mat=jnp.asarray(sph_mat),
            sph_active=jnp.asarray(sph_active),
            tri_v0=jnp.asarray(v0),
            tri_v1=jnp.asarray(v1),
            tri_v2=jnp.asarray(v2),
            tri_mat=jnp.asarray(t_mat),
            tri_active=jnp.asarray(t_active),
            mat_type=jnp.asarray([r["type"] for r in mat_rows], jnp.int32),
            mat_tex=jnp.asarray([r["tex"] for r in mat_rows], jnp.int32),
            mat_fuzz=jnp.asarray([r["fuzz"] for r in mat_rows], jnp.float32),
            mat_ior=jnp.asarray([r["ior"] for r in mat_rows], jnp.float32),
            mat_prob=jnp.asarray([r["prob"] for r in mat_rows], jnp.float32),
            mat_emission=jnp.asarray([r["emission"] for r in mat_rows], jnp.float32),
            tex=tables.texture_table(),
            sky_image=sky_img,
            bvh_min=jnp.asarray(bvh.node_min),
            bvh_max=jnp.asarray(bvh.node_max),
            bvh_first=jnp.asarray(bvh.node_first),
            bvh_count=jnp.asarray(bvh.node_count),
            bvh_miss=jnp.asarray(bvh.node_miss),
            sph_center_d=jnp.asarray(sph_center_b - sph_center) if animated else None,
            sph_radius_d=jnp.asarray(sph_radius_b - sph_radius) if animated else None,
            tri_v0_d=jnp.asarray(va_b[0] - v0) if animated and va_b else None,
            tri_v1_d=jnp.asarray(va_b[1] - v1) if animated and va_b else None,
            tri_v2_d=jnp.asarray(va_b[2] - v2) if animated and va_b else None,
            sky_kind=self.sky_kind,
            num_spheres=n,
            num_tris=m,
            use_bvh=use_bvh,
            bvh_leaf_size=leaf_size,
            animated=animated,
            motion_exact=motion_exact,
            tri_exact=tri_exact and m > 0,
            **track_fields,
        )
        self._cache = sd
        self._cache_key = key
        return sd

    # --- rendering ----------------------------------------------------------
    def render_scene(self, fname: str):
        """Movie if a duration was set, else a single image
        (src/scene/mod.rs:283-289)."""
        from crucible_tpu.models import render as render_mod

        if self.duration is not None:
            return render_mod.render_movie(self, fname)
        return render_mod.render_image_to_file(self, fname)
