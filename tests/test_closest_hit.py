"""The fused closest-hit (ops/intersect.py): broadcast multiply-adds and one
variadic min-reduction, checked against the float64 reference quadratic
(``chip_smoke.closest_hit64``), and its implicit-function VJP checked
against finite differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from crucible_tpu.ops import intersect

T_MIN = 1e-3


def _random_scene(rng, n_rays=700, n_spheres=37, inactive=0.2):
    o = rng.normal(size=(n_rays, 3)) * 3.0
    d = rng.normal(size=(n_rays, 3))
    c = rng.normal(size=(n_spheres, 3)) * 2.0
    r = rng.uniform(0.1, 1.0, n_spheres)
    act = rng.uniform(size=n_spheres) > inactive
    return tuple(jnp.asarray(x, jnp.float32) for x in (o, d, c, r)) + (jnp.asarray(act),)


def _both(o, d, c, r, act):
    got = intersect.hit_spheres(o, d, c, r, act, T_MIN, jnp.inf)
    want = chip_smoke.closest_hit64(o, d, c, r, act, T_MIN)
    return [np.asarray(x) for x in got], list(want)


def _assert_agrees(got, o, d, c, r, act):
    res = chip_smoke.compare_hits(got, o, d, c, r, act, T_MIN)
    assert res["unexplained_mismatch"] == 0 and res["t_outside_bound"] == 0, res
    return res


def test_matches_reference_random(rng):
    o, d, c, r, act = _random_scene(rng)
    got, want = _both(o, d, c, r, act)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1][want[2]], want[1][want[2]])
    res = _assert_agrees(got, o, d, c, r, act)
    assert res["hits_resolvable_to_1e6"] > 0
    assert got[2].mean() > 0.1  # the scene is actually hit


def test_padding_rows_never_win(rng):
    """Scene tables are padded with inactive unit spheres at the origin
    (models/scene.py SPHERE_PAD); rays through the origin must not hit
    them."""
    o, d, c, r, act = _random_scene(rng, n_spheres=5, inactive=0.0)
    c = jnp.concatenate([c, jnp.zeros((3, 3))])
    r = jnp.concatenate([r, jnp.ones((3,))])
    act = jnp.concatenate([act, jnp.zeros((3,), bool)])
    d = jnp.concatenate([d, -o], axis=0)  # second half aims at the origin
    o = jnp.concatenate([o, o], axis=0)
    got, want = _both(o, d, c, r, act)
    assert (got[1][got[2]] < 5).all()
    np.testing.assert_array_equal(got[1][want[2]], want[1][want[2]])
    _assert_agrees(got, o, d, c, r, act)


def test_inactive_rows_and_all_miss():
    o = jnp.asarray([[0.0, 0.0, 5.0], [0.0, 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
    c = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, 2.0]])
    r = jnp.asarray([1.0, 0.5])
    act = jnp.asarray([True, False])  # the nearer sphere is hidden
    t, idx, hit = intersect.hit_spheres(o, d, c, r, act, T_MIN, jnp.inf)
    assert bool(hit[0]) and int(idx[0]) == 0 and float(t[0]) == pytest.approx(4.0)
    # A miss reports BIG and index 0, like argmin over an all-BIG row.
    assert not bool(hit[1]) and int(idx[1]) == 0 and float(t[1]) == intersect.BIG


def test_exact_tie_takes_first_index():
    """Two identical spheres: the lower index wins (argmin semantics)."""
    o = jnp.asarray([[0.0, 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    c = jnp.asarray([[1.0, 1.0, 1.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    r = jnp.asarray([0.1, 1.0, 1.0])
    act = jnp.ones((3,), bool)
    got, want = _both(o, d, c, r, act)
    assert got[1][0] == want[1][0] == 1


@pytest.mark.parametrize("origin_z,expect_t", [(1.0 + 5e-4, 2.0 + 5e-4), (1.0 + 2e-3, 2e-3)])
def test_t_min_edge(origin_z, expect_t):
    """A ray starting just outside a unit sphere's surface, heading in: a
    near root inside t_min is rejected and the far root taken; just beyond
    t_min the near root wins."""
    o = jnp.asarray([[0.0, 0.0, origin_z]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    c = jnp.zeros((1, 3))
    r = jnp.ones((1,))
    act = jnp.ones((1,), bool)
    got, want = _both(o, d, c, r, act)
    assert got[2][0] and want[2][0]
    assert got[0][0] == pytest.approx(expect_t, abs=1e-5)
    assert got[0][0] == pytest.approx(want[0][0], abs=1e-5)


def test_leaving_a_surface_keeps_t():
    """A ray leaving a sphere's surface towards a second sphere: the
    expanded quadratic ``|c|^2 - 2 o.c + |o|^2 - r^2`` cancels here; the
    per-pair ``oc`` keeps t to f32 rounding."""
    c = jnp.asarray([[40.0, 1.0, -30.0], [43.0, 1.0, -30.0]])
    r = jnp.asarray([1.0, 1.0])
    o = jnp.asarray([[41.0, 1.0, -30.0]])  # on the first sphere's surface
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    got, want = _both(o, d, c, r, jnp.ones((2,), bool))
    assert got[1][0] == want[1][0] == 1
    assert got[0][0] == pytest.approx(want[0][0], rel=1e-6)


def test_min_with_index_matches_argmin(rng):
    x = rng.integers(0, 5, size=(64, 33)).astype(np.float32)  # many ties
    t, i = intersect.min_with_index(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(i), x.argmin(axis=1))
    np.testing.assert_array_equal(np.asarray(t), x.min(axis=1))


def test_moving_form_matches_static_at_shutter_ends(rng):
    o, d, c, r, act = _random_scene(rng)
    cd = jnp.asarray(rng.normal(size=c.shape) * 0.3, jnp.float32)
    rd = jnp.asarray(rng.uniform(-0.05, 0.05, r.shape), jnp.float32)
    for wv, cc, rr in ((0.0, c, r), (1.0, c + cd, r + rd)):
        w = jnp.full((o.shape[0],), wv, jnp.float32)
        got = intersect.hit_spheres_moving(o, d, w, c, cd, r, rd, act, T_MIN, jnp.inf)
        _assert_agrees(got, o, d, cc, rr, act)
        static = intersect.hit_spheres(o, d, cc, rr, act, T_MIN, jnp.inf)
        for a, b in zip(got, static):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sphere_roots_match_closest_hit(rng):
    """The replay's per-winner roots equal the reduction's t on the winner."""
    o, d, c, r, act = _random_scene(rng)
    t, idx, hit = intersect.hit_spheres(o, d, c, r, act, T_MIN, jnp.inf)
    near, far, q = intersect.sphere_roots(o, d, jnp.take(c, idx, 0), jnp.take(r, idx, 0))
    t_w = jnp.where(near > T_MIN, near, far)
    h = np.asarray(hit)
    assert (np.asarray(q)[h] >= 0).all()
    np.testing.assert_allclose(np.asarray(t_w)[h], np.asarray(t)[h], rtol=1e-6)


def _fd_setup():
    # Rays that hit well inside the silhouettes: t is smooth there.
    o = jnp.asarray([[0.1, 0.2, 5.0], [-0.2, 0.1, 6.0], [3.0, 0.05, 0.1]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.05, 0.0, -1.0], [-1.0, 0.0, 0.02]])
    c = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, -3.0]])
    r = jnp.asarray([1.0, 0.7])
    act = jnp.ones((2,), bool)
    return o, d, c, r, act


@pytest.mark.parametrize("arg", ["o", "d", "centers", "radii"])
def test_hit_vjp_matches_finite_differences(arg):
    """The implicit-function VJP (winner-only backward) against central
    differences of the float64 reference on the host."""
    o, d, c, r, act = _fd_setup()
    args = dict(o=o, d=d, centers=c, radii=r)
    wts = jnp.asarray([1.0, -0.7, 0.4])

    def f(x):
        kw = dict(args, **{arg: x})
        t, _, _ = intersect.hit_spheres(
            kw["o"], kw["d"], kw["centers"], kw["radii"], act, T_MIN, jnp.inf
        )
        return jnp.sum(t * wts)

    g = np.asarray(jax.grad(f)(args[arg]))

    def t64(x):
        kw = {k: np.asarray(v, np.float64) for k, v in args.items()}
        kw[arg] = x
        t, _, _ = chip_smoke.closest_hit64(
            kw["o"], kw["d"], kw["centers"], kw["radii"], np.asarray(act), T_MIN
        )
        return float(np.sum(t * np.asarray(wts, np.float64)))

    x0 = np.asarray(args[arg], np.float64)
    fd = np.zeros_like(x0)
    eps = 1e-5
    for idx in np.ndindex(x0.shape):
        xp, xm = x0.copy(), x0.copy()
        xp[idx] += eps
        xm[idx] -= eps
        fd[idx] = (t64(xp) - t64(xm)) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=2e-3, atol=2e-4)
