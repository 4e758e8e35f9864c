"""chip_smoke.py's phase functions at tiny sizes on the CPU: the same code
the GPU run executes at full width, with the CPU as both device and
reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke


def test_forward_cli(tmp_path):
    out = chip_smoke.forward_cli(tmp_path, width=48, spp=2)
    assert out["shape"] == (27, 48, 3)


def test_forward_vs_cpu():
    out = chip_smoke.forward_vs_cpu(width=48, spp=2, depth=6, n_pixels=256)
    assert out["frac_over_1e3"] == 0.0 and out["mean_abs"] == 0.0


def test_closest_hit():
    out = chip_smoke.closest_hit(n_rays=1024, width=48, stress_copies=2)
    assert out["book1"]["rows"] == 488 and out["sphere_stress"]["rows"] == 968
    for res in out.values():
        assert res["unexplained_mismatch"] == 0 and res["hits"] > 0


def test_compare_hits_flags_a_wrong_winner():
    """The comparison must fail a form that picks a farther sphere, or the
    right sphere at a t off by 2.5e-5 relative."""
    o = jnp.asarray([[0.0, 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    c = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, -3.0]])
    r = jnp.asarray([1.0, 1.0])
    act = np.ones(2, bool)
    right = (np.asarray([4.0], np.float32), np.asarray([0]), np.asarray([True]))
    wrong = (np.asarray([7.0], np.float32), np.asarray([1]), np.asarray([True]))
    off = (np.asarray([4.0001], np.float32), np.asarray([0]), np.asarray([True]))
    assert chip_smoke.compare_hits(right, o, d, c, r, act)["unexplained_mismatch"] == 0
    assert chip_smoke.compare_hits(wrong, o, d, c, r, act)["unexplained_mismatch"] == 1
    assert chip_smoke.compare_hits(off, o, d, c, r, act)["t_outside_bound"] == 1


def test_compare_grads_flags_a_wrong_leaf():
    """A leaf 64x off fails even where rounding alone moves it by half."""
    ref = {"cam_vfov": np.float32(2.0), "tex_color": np.ones((4, 3), np.float32)}
    sens = {"cam_vfov": 0.5, "tex_color": 0.0}
    chip_smoke._compare_grads(1.0, ref, 1.0, ref, sens)
    wrong = dict(ref, cam_vfov=np.float32(128.0))
    with pytest.raises(AssertionError):
        chip_smoke._compare_grads(1.0, wrong, 1.0, ref, sens)
    off = dict(ref, tex_color=ref["tex_color"] * np.float32(1.001))
    with pytest.raises(AssertionError):
        chip_smoke._compare_grads(1.0, off, 1.0, ref, sens)


def test_train():
    out = chip_smoke.train(width=32, spp=2, depth=4, steps=2)
    assert len(out["losses"]) == 2 and np.isfinite(out["frozen_loss"])


def test_grad_vs_cpu():
    out = chip_smoke.grad_vs_cpu(width=32, n_pixels=128, spp=2, depth=4)
    assert out["loss_rel"] == 0.0


def test_movie(tmp_path):
    out = chip_smoke.movie(tmp_path, frames=2)
    assert out["frames"] == 2


def test_four_cards_on_virtual_devices():
    """The four-card phase over the CPU's virtual devices (conftest sets 8;
    the phase takes a mesh of all of them)."""
    out = chip_smoke.four_cards(
        width=32, still_spp=2, still_depth=4, grad_width=32, n_pixels=64,
        spp=2, depth=4,
    )
    assert out["devices"] == len(jax.devices())
    assert out["still_identical_to_one_card"]


def test_phase_prints_compile_and_wall(capsys):
    with chip_smoke.phase("probe"):
        jax.jit(lambda x: x * 3)(jnp.arange(7.0)).block_until_ready()
    line = capsys.readouterr().out.strip()
    assert line.startswith("phase probe: compile ") and line.endswith(" s")

