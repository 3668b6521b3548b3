"""The port's multi-device renderer and sharded training step
(``gsconverter_tpu_torch.parallel.distributed``'s ``sharded_render``,
``band_occupancy`` and ``sharded_render_tiles``; ``parallel.train``) on the
CPU, against the single-device port and the JAX package.

One gloo world of W processes a world size (``tests/torch_dist_helpers.py``,
scenario ``render``) runs every case once for the module; the tests read its
results.  The JAX side runs here, on a W-device slice of the virtual CPU
mesh, with its ``shard_map`` bodies under ``jax.jit`` (the same computation;
run eagerly, each op of a body dispatches on its own and a call takes 5-30
s).  Scenes are ``tests/test_parallel.py``'s.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsconverter_tpu.parallel import distributed as jd
from gsconverter_tpu.render import Camera as JCamera
from gsconverter_tpu.render import render as jrender
from gsconverter_tpu_torch.parallel import distributed as pd
from gsconverter_tpu_torch.parallel.mesh import make_mesh as t_make_mesh
from gsconverter_tpu_torch.parallel.sharding import pad_cloud
from gsconverter_tpu_torch.parallel.train import dryrun_multichip, tiny_scene
from gsconverter_tpu_torch.render import rasterizer as tr
from tests.conftest import cpu_devices, make_cloud
from tests.torch_dist_helpers import cloud_leaves, run_world
from tests.torch_port_helpers import to_port, to_port_camera

WORLDS = (2, 4)
TRAINABLE = ("pos", "sh_dc", "sh_rest", "opacity", "log_scale", "quat")


def jax_mesh(w):
    from gsconverter_tpu.parallel.mesh import make_mesh

    return make_mesh(devices=cpu_devices()[:w])


@contextlib.contextmanager
def jitted_shard_map():
    """The JAX module's ``shard_map`` bodies compiled once by ``jax.jit``."""
    orig = jd.shard_map

    def shard_map(f=None, **kw):
        if f is None:
            return lambda g: jax.jit(orig(g, **kw))
        return jax.jit(orig(f, **kw))
    jd.shard_map = shard_map
    try:
        yield
    finally:
        jd.shard_map = orig


def compact(c):
    """test_parallel.py's render scene treatment: a compact cloud in front
    of the camera."""
    return c.replace(pos=c.pos * 0.5, log_scale=jnp.clip(c.log_scale, -5.0, -2.0),
                     opacity=jnp.clip(c.opacity, -3.0, 3.0))


def render_scene():
    """test_parallel.py:67-77: 256 splats, SH degree 1."""
    return compact(make_cloud(256, sh_degree=1))


def pressure_scene():
    """test_parallel.py:174-179: every splat covers every band."""
    c = make_cloud(512, sh_degree=0)
    return c.replace(pos=c.pos * 0.3, log_scale=jnp.full_like(c.log_scale, -0.5),
                     opacity=jnp.clip(c.opacity, -3.0, 0.0))


def giant_scene():
    """64 small splats and one real giant behind the origin (depth 7.5), at
    128 x 128: there JAX's padding rows (unit-scale splats at the origin,
    depth 6, radius 56 px) are giants too, in front of the real one."""
    c = compact(make_cloud(65, sh_degree=0, seed=5))
    pos, ls, op = np.array(c.pos), np.array(c.log_scale), np.array(c.opacity)
    pos[0], ls[0], op[0] = [0.0, 0.0, 1.5], [0.3, 0.3, 0.3], 2.0
    return c.replace(pos=jnp.asarray(pos), log_scale=jnp.asarray(ls), opacity=jnp.asarray(op))


def cam(width, height):
    return JCamera.look_at(eye=(0, 0, -6), target=(0, 0, 0), width=width, height=height)


GIANT_KW = dict(max_per_tile=256, max_global=16)
#: (scene, camera, budget, render kw) of each tile-sharded case
TILE_CASES = {
    "tiles": (render_scene, (32, 128), 512, dict(max_per_tile=256)),
    "auto": (pressure_scene, (32, 128), None, dict(max_per_tile=512)),
    "capped": (pressure_scene, (32, 128), "demand/4", dict(max_per_tile=512)),
    "giant": (giant_scene, (128, 128), None, GIANT_KW),
}


def padded_leaves(c, w):
    return cloud_leaves(pad_cloud(to_port(c), w)[0])


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request, tmp_path_factory):
    w = request.param
    tiles = {}
    for name, (scene, (width, height), budget, kw) in TILE_CASES.items():
        if budget == "demand/4":
            budget = max(1, max_band_demand(w) // 4)
        tiles[name] = (padded_leaves(scene(), w), to_port_camera(cam(width, height)),
                       budget, kw)
    inputs = dict(
        render=(padded_leaves(render_scene(), w), to_port_camera(cam(32, 32)),
                dict(max_per_tile=256)),
        tiles=tiles,
        occupancy={"tiles": (padded_leaves(render_scene(), w),
                             to_port_camera(cam(32, 128))),
                   "pressure": (padded_leaves(pressure_scene(), w),
                                to_port_camera(cam(32, 128)))},
        rows_split=(padded_leaves(render_scene(), w), to_port_camera(cam(32, 48))),
        step=dict(n=16 * w, width=32, height=max(32, 16 * w)),
    )
    return w, inputs, run_world("render", w, tmp_path_factory.mktemp("render"), inputs)


def max_band_demand(w):
    """The pressure scene's largest (source, band) demand at world ``w``:
    every splat covers every band, so each source's whole chunk."""
    return len(pad_cloud(to_port(pressure_scene()), w)[0].pos) // w


def jax_occupancy(scene, camera, w):
    from gsconverter_tpu.parallel.sharding import pad_cloud as jpad

    with jitted_shard_map():
        return np.asarray(jd.band_occupancy(jpad(scene, w)[0], camera, jax_mesh(w)))


def single(scene, camera, **kw):
    """The single-device port's image."""
    return tr.render(to_port(scene), to_port_camera(camera), device="cpu", **kw).numpy()


def psnr(a, b):
    return float(tr.psnr(torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b))))


def rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------------- tests


def test_world_of_one_is_the_single_device_render():
    """No group: every collective is the identity, the prefix is 1."""
    mesh = t_make_mesh(device="cpu")
    c, camera = to_port(render_scene()), to_port_camera(cam(32, 128))
    kw = dict(max_per_tile=256)
    one = tr.render(c, camera, bg=torch.zeros(3), device="cpu", **kw)
    assert torch.equal(pd.sharded_render(c, camera, mesh, **kw), one)
    assert pd.band_occupancy(c, camera, mesh).tolist() == [[256]]
    assert psnr(pd.sharded_render_tiles(c, camera, mesh, **kw), one) > 100.0
    res = dryrun_multichip(mesh)
    assert res["d_loss"] == 0.0 and res["d_pos"] == 0.0


@pytest.mark.parametrize("rows", [(0, 16), (16, 48), (48, 64)])
def test_render_rows_are_the_whole_images_rows(rows):
    """What the sharded step renders a rank: the whole image's projection
    and binning, the band's tiles composited (chunks of tile_chunk tiles
    that start where the whole image's do, so their exit is the same)."""
    c, camera = to_port(render_scene()), to_port_camera(cam(32, 64))
    kw = dict(max_per_tile=256, tile_chunk=2)
    whole = tr.render(c, camera, device="cpu", **kw)
    assert torch.equal(tr.render(c, camera, rows=rows, device="cpu", **kw),
                       whole[rows[0]:rows[1]])


def test_a_band_camera_moves_the_band_where_rows_do_not():
    """Why the sharded step renders its band by ``render(rows=)``: JAX's
    band camera moves cy, and the projection's frustum clamp (1.3 cy / fy)
    reads it (at cy = 0 every ty clamps to 0), so the band's footprints
    move."""
    import dataclasses

    c, camera = to_port(render_scene()), to_port_camera(cam(32, 64))
    kw = dict(max_per_tile=256, tile_chunk=2)
    whole = tr.render(c, camera, device="cpu", **kw)
    band_cam = dataclasses.replace(camera, cy=camera.cy - 32.0, height=32)
    moved = tr.render(c, band_cam, device="cpu", **kw)
    assert rel_err(moved, whole[32:]) > 1e-3  # rounding alone moves it by ~1e-6
    assert torch.equal(tr.render(c, camera, rows=(32, 64), device="cpu", **kw), whole[32:])


def test_render_rows_refuses_what_does_not_split():
    c, camera = to_port(render_scene()), to_port_camera(cam(32, 64))
    for rows in ((8, 24), (0, 80), (32, 32)):
        with pytest.raises(ValueError, match="rows must be multiples"):
            tr.render(c, camera, rows=rows, device="cpu")
    b = tr.auto_budget(c, camera, band_chunk=2, device="cpu")
    with pytest.raises(ValueError, match="do not combine"):
        tr.render(c, camera, rows=(0, 16), tile_order=b["tile_order"],
                  band_plan=b["band_plan"], tile_chunk=2, device="cpu")


@pytest.mark.parametrize("scene", ["tiles", "pressure"])
def test_band_occupancy_equals_jax(world, scene):
    w, inputs, res = world
    make = render_scene if scene == "tiles" else pressure_scene
    want = jax_occupancy(make(), cam(32, 128), w)
    for r in range(w):
        got = res[r][f"occupancy_{scene}"]
        assert got.shape == (w, w) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_sharded_render_matches_jax_and_single(world):
    from gsconverter_tpu.parallel.sharding import pad_cloud as jpad

    w, _, res = world
    c = render_scene()
    with jitted_shard_map():
        want = np.asarray(jd.sharded_render(jpad(c, w)[0], cam(32, 32), jax_mesh(w),
                                            max_per_tile=256))
    one = single(c, cam(32, 32), max_per_tile=256)
    for r in range(w):
        img = res[r]["render"]
        assert img.shape == (32, 32, 3)
        np.testing.assert_allclose(img, want, rtol=0, atol=1e-5)
        assert psnr(img, one) > 35.0
        np.testing.assert_array_equal(img, res[0]["render"])


def test_tile_sharded_render_matches_jax_and_single(world):
    from gsconverter_tpu.parallel.sharding import pad_cloud as jpad

    w, inputs, res = world
    c = render_scene()
    with jitted_shard_map():
        want = np.asarray(jd.sharded_render_tiles(jpad(c, w)[0], cam(32, 128), jax_mesh(w),
                                                  budget=512, max_per_tile=256))
    one = single(c, cam(32, 128), max_per_tile=256)
    n = len(inputs["tiles"]["tiles"][0]["pos"])
    if w == 4:
        # bands 0 and 3 receive no splat: their rows are the background
        assert res[0]["occupancy_tiles"].sum(0).tolist()[::3] == [0, 0]
    for r in range(w):
        img, printed, sent = res[r]["tiles_tiles"]
        assert img.shape == (128, 32, 3) and printed == ""
        assert psnr(img, want) > 35.0 and psnr(img, one) > 35.0
        np.testing.assert_array_equal(img, res[0]["tiles_tiles"][0])
        # one all-to-all of [w, min(budget, chunk), 61] f32, one all-gather
        # of this rank's band, one of its occupancy row
        assert sent["all_to_all"] == w * min(512, n // w) * 61 * 4
        assert sent["all_gather"] == (128 // w) * 32 * 3 * 4 + w * 4


def test_tile_sharded_render_budget_pressure(world):
    """test_parallel.py:159-199: the auto budget drops nothing; a quarter
    of the demand prints JAX's warning with JAX's dropped count and stays
    within a bounded PSNR (the farthest splats drop first)."""
    w, inputs, res = world
    one = single(pressure_scene(), cam(32, 128), max_per_tile=512)
    occ = jax_occupancy(pressure_scene(), cam(32, 128), w)
    need = int(occ.max())
    assert need >= 32 and need == max_band_demand(w)
    budget = inputs["tiles"]["capped"][2]
    dropped = int(np.maximum(occ - budget, 0).sum())
    warning = (f"Warning: sharded_render_tiles budget={budget} saturated — max band "
               f"demand {need}; {dropped} farthest splat-sends truncated (pass "
               "budget=None to auto-size).")
    for r in range(w):
        img, printed, _ = res[r]["tiles_auto"]
        assert printed == "" and psnr(img, one) > 35.0
        img, printed, _ = res[r]["tiles_capped"]
        assert printed.strip() == (warning if r == 0 else "")
        assert psnr(img, one) > 15.0


def test_tile_sharded_render_rows_must_split(world):
    w, _, res = world
    for r in range(w):
        assert "48 image rows do not split" in res[r]["rows_split"]
    # the JAX package refuses the same camera
    from gsconverter_tpu.parallel.sharding import pad_cloud as jpad

    with pytest.raises(AssertionError):
        jd.sharded_render_tiles(jpad(render_scene(), w)[0], cam(32, 48), jax_mesh(w))


def test_tile_sharded_render_drops_padding_rows(world):
    """A deliberate divergence: the port renders only the rows a band really
    received.  JAX also renders each source's unfilled budget as padding
    rows, unit-scale splats at the origin; at 128 px they are giants in
    front of the scene's real giant, take every one of ``max_global``
    global slots, and the real giant vanishes from JAX's image."""
    from gsconverter_tpu.parallel.sharding import pad_cloud as jpad

    w, _, res = world
    c = giant_scene()
    with jitted_shard_map():
        jax_img = np.asarray(jd.sharded_render_tiles(jpad(c, w)[0], cam(128, 128),
                                                     jax_mesh(w), **GIANT_KW))
    one = single(c, cam(128, 128), **GIANT_KW)
    without_giant = single(c.replace(opacity=c.opacity.at[0].set(-30.0)), cam(128, 128),
                           **GIANT_KW)
    # JAX's image is the scene without its giant (17.6 dB against it)
    assert psnr(jax_img, without_giant) > 50.0 and psnr(jax_img, one) < 20.0
    for r in range(w):
        img = res[r]["tiles_giant"][0]
        assert psnr(img, one) > 35.0


def test_sharded_step_matches_single_device(world):
    """dryrun_multichip's bars, and the gradients: only their summation
    order differs (an all-reduce of the bands' against one index_add_)."""
    w, _, res = world
    for r in range(w):
        sh, one = res[r]["step_sharded"], res[r]["step_single"]
        assert abs(sh["loss"] - one["loss"]) < 1e-5
        for k in TRAINABLE:
            assert rel_err(sh["grads"][k], one["grads"][k]) <= 1e-5, k
            assert float(np.abs(sh["params"][k] - one["params"][k]).max()) < 1e-5, k
        # every rank took the same step
        assert sh["digest"] == res[0]["step_sharded"]["digest"]
        # one all-reduce of every gradient, one of the loss
        n = sum(v.size for v in sh["grads"].values())
        assert sh["bytes"]["all_reduce"] == (n + 1) * 4
        norms = np.linalg.norm(sh["params"]["quat"], axis=-1)
        np.testing.assert_allclose(norms, 1.0, rtol=1e-6)


def test_sharded_step_matches_jax(world):
    """Against JAX's single-device step (render, optax.adam) on
    ``__graft_entry__._tiny_scene``: loss 1e-5, gradients rel 1e-4."""
    from __graft_entry__ import _tiny_scene

    w, inputs, res = world
    jc, _ = _tiny_scene(n=16 * w)
    height = inputs["step"]["height"]
    tc, _ = tiny_scene(**inputs["step"])
    for k in TRAINABLE:
        np.testing.assert_array_equal(getattr(tc, k), np.asarray(getattr(jc, k)), k)
    jcam = cam(32, height)
    params = {k: getattr(jc, k) for k in TRAINABLE}

    def loss_fn(p):
        img = jrender(jc.replace(**p), jcam, max_per_tile=64, tile_chunk=2)
        return jnp.mean(img ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    for r in range(w):
        sh = res[r]["step_sharded"]
        assert abs(sh["loss"] - float(loss)) < 1e-5
        for k in TRAINABLE:
            assert rel_err(sh["grads"][k], grads[k]) <= 1e-4, k


def test_dryrun_multichip_meets_its_bars(world):
    w, _, res = world
    for r in range(w):
        out = res[r]["dryrun"]
        assert out["world"] == w
        assert out["d_loss"] < 1e-5 and out["d_pos"] < 1e-5
        assert out["loss"] == res[0]["dryrun"]["loss"]
