"""The port's differentiable rasterizer and training step against the JAX
package on the CPU (BASELINE config 4): projection, SH, the tiled render in
every binning mode, pixel gradients, the budget planner and ``fit``.

Scenes are ``tests/test_render.py``'s, built from numpy seeds; each goes
through both packages as the same numpy arrays."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gsconverter_tpu.render import rasterizer as jr
from gsconverter_tpu.render.camera import Camera as JCamera
from gsconverter_tpu.render.project import covariance_3d as j_cov
from gsconverter_tpu.render.project import project_gaussians as j_project
from gsconverter_tpu.render.project import quat_to_rotmat as j_rotmat
from gsconverter_tpu_torch.render import rasterizer as tr
from gsconverter_tpu_torch.render.camera import Camera as TCamera
from gsconverter_tpu_torch.render.project import covariance_3d as t_cov
from gsconverter_tpu_torch.render.project import project_gaussians as t_project
from gsconverter_tpu_torch.render.project import quat_to_rotmat as t_rotmat
from tests.conftest import make_cloud
from tests.test_render import scene, structured_scene
from tests.torch_port_helpers import clamp_edge_windows, to_port, to_port_camera

NAMES = ("pos", "opacity", "sh_dc", "sh_rest", "log_scale", "quat")


def t(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


def giant_scene(n=64):
    """``test_render.py``'s near-camera giant over a 64-splat scene, at
    128 x 128 (the global-escape case)."""
    c, _ = scene(n)
    cam = JCamera.look_at(eye=(0, 0, -6), target=(0, 0, 0), width=128, height=128)
    pos, ls, op = np.array(c.pos), np.array(c.log_scale), np.array(c.opacity)
    pos[0], ls[0], op[0] = [0.0, 0.0, -4.0], [0.3, 0.3, 0.3], 2.0
    return c.replace(pos=jnp.asarray(pos), log_scale=jnp.asarray(ls),
                     opacity=jnp.asarray(op)), cam


# ------------------------------------------------------------- projection


def test_quat_to_rotmat_and_covariance_match_jax():
    c = make_cloud(500, seed=4)
    np.testing.assert_allclose(t_rotmat(t(c.quat)).numpy(), np.asarray(j_rotmat(c.quat)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_cov(t(c.log_scale), t(c.quat)).numpy(),
                               np.asarray(j_cov(c.log_scale, c.quat)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", ["scene", "structured", "giant"])
def test_project_gaussians_matches_jax(which):
    c, cam = {"scene": lambda: scene(600), "structured": lambda: structured_scene(20_000),
              "giant": giant_scene}[which]()
    pj = jax.jit(j_project)(c.pos, c.log_scale, c.quat, cam)
    pt = t_project(t(c.pos), t(c.log_scale), t(c.quat), to_port_camera(cam))
    assert sorted(pj) == sorted(pt)
    for k in ("means2d", "conic", "depth", "view_dir"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(pt["in_front"].numpy(), np.asarray(pj["in_front"]))
    # radius = ceil(3 sqrt(lam1)): equal except where 3 sqrt(lam1) lies
    # within 1e-5 relative of an integer, where ceil may flip by one
    rj, rt = np.asarray(pj["radius"]), pt["radius"].numpy()
    diff = rj != rt
    assert not diff.any() or np.abs(rj[diff] - rt[diff]).max() == 1.0
    assert diff.mean() < 1e-3


def test_camera_look_at_bit_equal_and_moves():
    for eye, target, fov, w, h in [((0, 0, -6), (0, 0, 0), 60.0, 64, 64),
                                   ((0.3, -1.5, 5.0), (0.1, 0.2, 0.0), 40.0, 1920, 1088),
                                   ((2.0, 1.0, -3.0), (0, 0.5, 0), 75.0, 256, 128)]:
        cj = JCamera.look_at(eye=eye, target=target, fov_deg=fov, width=w, height=h)
        ct = TCamera.look_at(eye=eye, target=target, fov_deg=fov, width=w, height=h)
        for k in ("world_to_cam", "fx", "fy", "cx", "cy"):
            a, b = np.asarray(getattr(cj, k)), getattr(ct, k).numpy()
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), k
        assert (ct.width, ct.height) == (w, h)
        np.testing.assert_allclose(ct.position.numpy(), np.asarray(cj.position), atol=1e-6)
        assert ct.to("cpu") is ct and ct.device == torch.device("cpu")
        back = to_port_camera(cj)
        assert torch.equal(back.world_to_cam, ct.world_to_cam)


# --------------------------------------------------------------------- SH


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax_and_is_differentiable(degree):
    from gsconverter_tpu.ops.sh import eval_sh as j_eval
    from gsconverter_tpu_torch.ops.sh import eval_sh as t_eval

    c = make_cloud(400, sh_degree=degree, seed=degree)
    dirs = np.random.default_rng(9).normal(0, 1, (400, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    want = np.asarray(j_eval(c, jnp.asarray(dirs)))
    pc = to_port(c).to_device("cpu")
    dc, rest = pc.sh_dc.requires_grad_(True), pc.sh_rest.requires_grad_(True)
    got = t_eval(pc.replace(sh_dc=dc, sh_rest=rest), t(dirs))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    got.sum().backward()
    np.testing.assert_allclose(dc.grad.numpy(), np.full((400, 3), 0.28209479177387814),
                               rtol=1e-6)
    gj = jax.grad(lambda r: j_eval(c.replace(sh_rest=r), jnp.asarray(dirs)).sum())(c.sh_rest)
    g_rest = torch.zeros_like(rest) if rest.grad is None else rest.grad  # unused at degree 0
    np.testing.assert_allclose(g_rest.numpy(), np.asarray(gj), atol=1e-6)


# ------------------------------------------------------------------ render

RENDER_CASES = {
    "windowed": dict(),
    "windowed_budget_300_bm16_chunk4": dict(max_per_tile=300, block_m=16, tile_chunk=4),
    "windowed_bg_bm1": dict(max_per_tile=128, block_m=1, tile_chunk=8,
                            bg=(0.2, 0.5, 0.9)),
    "exact": dict(binning="exact", max_per_tile=300),
    "exact_sh1_chunk16": dict(binning="exact", max_per_tile=200, sh_degree=1,
                              tile_chunk=16, block_m=64),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_matches_jax(case):
    c, cam = scene()
    kw = RENDER_CASES[case]
    jkw = dict(kw, bg=jnp.asarray(kw["bg"])) if "bg" in kw else kw
    want = np.asarray(jr.render(c, cam, **jkw))
    got = tr.render(to_port(c), to_port_camera(cam), device="cpu", **kw)
    assert got.shape == (64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_render_reference_matches_jax():
    c, cam = giant_scene()
    want = np.asarray(jr.render_reference(c, cam))
    got = tr.render_reference(to_port(c), to_port_camera(cam), device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the giant reaches the corners through the global escape
    img_w = tr.render(to_port(c), to_port_camera(cam), max_per_tile=400, device="cpu")
    assert float(tr.psnr(img_w, torch.from_numpy(got))) > 38.0


def test_banded_render_matches_jax():
    c, cam = structured_scene(n=20_000)
    b = jr.auto_budget(c, cam, cap=16384, band_chunk=2, saturation=False)
    kw = dict(binning="windowed", max_global=b["max_global"], tile_chunk=2,
              band_plan=b["band_plan"])
    want = np.asarray(jr.render(c, cam, tile_order=jnp.asarray(b["tile_order"]), **kw))
    got = tr.render(to_port(c), to_port_camera(cam), tile_order=b["tile_order"],
                    device="cpu", **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    flat = tr.render(to_port(c), to_port_camera(cam), max_per_tile=b["max_per_tile"],
                     max_global=b["max_global"], tile_chunk=4, device="cpu")
    assert float(tr.psnr(got, flat)) > 50.0


def test_global_candidates_take_window_slots_as_in_jax():
    """ADVICE r5 (rasterizer.py:449): the injected globals take
    ``max_per_tile`` slots.  With a budget of 8 some tiles' runs exceed it,
    the giant sits first in them, and a deeper candidate is displaced; the
    port renders what JAX renders."""
    c, cam = giant_scene()
    pc, pcam = to_port(c), to_port_camera(cam)
    budget = 8
    proj = t_project(t(c.pos), t(c.log_scale), t(c.quat), pcam)
    depth_key = torch.where(proj["in_front"], proj["depth"], torch.inf)
    sorted_tid, entry = tr._bin_windowed(proj["means2d"], proj["radius"], proj["in_front"],
                                         depth_key, 32, 16384, 8, 8)
    runs = torch.bincount(sorted_tid[sorted_tid < 64], minlength=64)
    starts = torch.searchsorted(sorted_tid, torch.arange(64))
    displaced = [int(ti) for ti in range(64)
                 if runs[ti] > budget and 0 in entry[starts[ti]:starts[ti] + budget].tolist()]
    assert displaced, "no tile where the global takes a slot from a candidate"
    want = np.asarray(jr.render(c, cam, max_per_tile=budget))
    got = tr.render(pc, pcam, max_per_tile=budget, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    roomy = tr.render(pc, pcam, max_per_tile=64, device="cpu").numpy()
    assert np.abs(roomy - got).max() > 1e-3  # the displaced candidates show


# --------------------------------------------------------------- gradients


def _port_grads(c, cam, kw, target, fn=None):
    ps = {k: t(getattr(c, k)).requires_grad_(True) for k in NAMES}
    img = (fn or tr.render)(to_port(c).replace(**ps), to_port_camera(cam), device="cpu", **kw)
    torch.mean((img - torch.from_numpy(np.array(target))) ** 2).backward()
    return {k: ps[k].grad.numpy() for k in NAMES}


@pytest.mark.parametrize("case", ["windowed", "exact_bm16"])
def test_pixel_gradients_match_jax(case):
    c, cam = scene(n=100)
    kw = dict(max_per_tile=128) if case == "windowed" else dict(
        max_per_tile=100, binning="exact", block_m=16)
    target = jnp.ones((64, 64, 3)) * 0.5

    def loss(*args):
        return jnp.mean((jr.render(c.replace(**dict(zip(NAMES, args))), cam, **kw)
                         - target) ** 2)

    gj = jax.grad(loss, argnums=tuple(range(6)))(*[getattr(c, k) for k in NAMES])
    gt = _port_grads(c, cam, kw, target)
    for k, g in zip(NAMES, gj):
        assert rel_err(gt[k], g) <= 1e-4, (k, rel_err(gt[k], g))


def test_banded_opacity_gradient_matches_jax():
    """The bench's loss: d sum(img^2) / d opacity through the banded path."""
    c, cam = structured_scene(n=20_000)
    b = jr.auto_budget(c, cam, cap=16384, band_chunk=2)
    kw = dict(binning="windowed", max_global=b["max_global"], tile_chunk=2,
              block_m=64, band_plan=b["band_plan"])
    gj = jax.grad(lambda op: jnp.sum(jr.render(
        c.replace(opacity=op), cam, tile_order=jnp.asarray(b["tile_order"]), **kw) ** 2))(
        c.opacity)
    op = t(c.opacity).requires_grad_(True)
    img = tr.render(to_port(c).replace(opacity=op), to_port_camera(cam),
                    tile_order=b["tile_order"], device="cpu", **kw)
    torch.sum(img * img).backward()
    assert np.abs(np.asarray(gj)).max() > 0
    assert rel_err(op.grad.numpy(), gj) <= 1e-4


def test_tiled_gradients_match_port_reference():
    """The port's tiled gradients against its own naive renderer, at the
    JAX package's own 2e-3 bar (test_render.py)."""
    c, cam = scene(n=100)
    target = np.full((64, 64, 3), 0.5, np.float32)
    gt = _port_grads(c, cam, dict(max_per_tile=128), target)
    gr = _port_grads(c, cam, {}, target, fn=tr.render_reference)
    for k in NAMES:
        if k == "sh_rest":
            continue  # a degree-2 scene: compared at 2e-3 like the rest below
        assert rel_err(gt[k], gr[k]) <= 2e-3, k
    assert rel_err(gt["sh_rest"], gr["sh_rest"]) <= 2e-3


# ------------------------------------------------------------- compositing


def _windows(c_sz=3, m=32, seed=0, dtype=torch.float32, alpha_hi=0.6):
    r = np.random.default_rng(seed)
    mean = r.uniform(-2, tr.TILE + 2, (c_sz, m, 2))
    ca, cc = r.uniform(0.02, 0.3, (c_sz, m)), r.uniform(0.02, 0.3, (c_sz, m))
    cb = r.uniform(-0.5, 0.5, (c_sz, m)) * np.sqrt(ca * cc)
    color = r.uniform(0, 1, (c_sz, m, 3))
    geo = np.concatenate([mean, ca[..., None], cb[..., None], cc[..., None], color], -1)
    alpha = r.uniform(0.05, alpha_hi, (c_sz, m))
    origin = r.integers(0, 4, (c_sz, 2)) * 16.0
    geo[..., 0:2] += origin[:, None, :]
    f = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return f(geo), f(alpha), f(origin)


def test_composite_gradcheck_f64():
    """torch.autograd.gradcheck of the plain ``_composite`` (analytic
    backward) in f64, at a tiny size, away from the clamps and the exit."""
    geo, alpha, origin = _windows(c_sz=2, m=8, seed=1, dtype=torch.float64, alpha_hi=0.3)
    counts = torch.tensor([8, 5], dtype=torch.int32)
    alpha[1, 5:] = 0.0  # invalid slots beyond the count
    bg = torch.tensor([0.1, 0.4, 0.7], dtype=torch.float64)
    for per_tile in (False, True):
        fn = lambda g, a, b: tr._composite(4, g, a, origin, counts, b, per_tile)  # noqa: E731
        assert torch.autograd.gradcheck(
            fn, (geo.clone().requires_grad_(True), alpha.clone().requires_grad_(True),
                 bg.clone().requires_grad_(True)), eps=1e-6, atol=1e-6, rtol=1e-4,
            fast_mode=True)  # random projections of the 1,536 outputs


@pytest.mark.parametrize("bm", [4, 8, 16])
def test_composite_bwd_keeps_the_clamp_edges_as_jax(bm):
    """The plain backward against JAX's ``_composite_bwd`` on windows whose
    pairs sit on the edges a cached alpha must keep: power in (-3e-8, 0)
    (gauss rounds to 1, d_power is not 0), raw exactly 0.99 (not live) and
    a exactly 1/255 (live)."""
    geo, alpha, origin, counts = clamp_edge_windows()
    tg, ta, to = t(geo), t(alpha), t(origin)
    gx, gy = tr._pixel_grid(to)
    a, raw, gauss, power, _, _ = tr._block_alpha(tg[..., 0:2], tg[..., 2:5], ta, gx, gy)
    assert bool(((power < 0) & (power > -3e-8) & (gauss == 1.0)).any())
    assert bool((raw == np.float32(tr.ALPHA_MAX)).any())
    assert bool((a == np.float32(tr.ALPHA_MIN)).any())
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    grgb = np.random.default_rng(4).uniform(-1, 1, (3, tr.PIXELS, 3)).astype(np.float32)
    jm, jc, jcol, ja = (jnp.asarray(x) for x in (geo[..., 0:2], geo[..., 2:5],
                                                  geo[..., 5:8], alpha))
    jgx, jgy = jnp.asarray(gx.numpy()), jnp.asarray(gy.numpy())
    n_valid = jnp.float32(counts.max())
    rgb_j, ts_j, tf_j, nd_j = jr._composite_fwd_impl(bm, jm, jc, jcol, ja, jgx, jgy,
                                                     jnp.asarray(bg), n_valid)
    gj = jr._composite_bwd(bm, (jm, jc, jcol, ja, jgx, jgy, jnp.asarray(bg), ts_j, tf_j,
                                nd_j), jnp.asarray(grgb))
    rgb_t, ts_t, tf_t, nd_t = tr._composite_fwd_ref(bm, tg, ta, to, t(counts), t(bg),
                                                    per_tile=False)
    assert rel_err(rgb_t.numpy(), rgb_j) <= 1e-5
    assert int(nd_t.max()) == int(nd_j)
    d_geo, d_al, d_bg = tr._composite_bwd_ref(bm, tg, ta, to, t(bg), ts_t, tf_t, nd_t,
                                              t(grgb))
    for got, want in ((d_geo[..., 0:2], gj[0]), (d_geo[..., 2:5], gj[1]),
                      (d_geo[..., 5:8], gj[2]), (d_al, gj[3]), (d_bg, gj[6])):
        assert rel_err(got.numpy(), want) <= 1e-4
    # the edge splats' own rows: tile 0's mean x (all from the pixel where
    # power is in (-3e-8, 0)), tiles 1-2's alpha
    for got, want in ((d_geo[0, 5, 0], gj[0][0, 5, 0]), (d_al[1, 6], gj[3][1, 6]),
                      (d_al[2, 7], gj[3][2, 7])):
        assert float(want) != 0.0 and rel_err(got.numpy(), want) <= 1e-4


def test_per_tile_exit_equals_chunks_of_one_and_bounds_the_chunk_exit():
    geo, alpha, origin = _windows(c_sz=6, m=64, seed=2, alpha_hi=0.99)
    alpha[:3] = 0.97  # tiles 0-2 saturate early, 3-5 maybe not at all
    alpha[5, 40:] = 0.0
    counts = torch.tensor([64, 64, 64, 64, 64, 40], dtype=torch.int32)
    bg = torch.tensor([0.3, 0.0, 1.0])
    per = tr._composite_fwd_ref(16, geo, alpha, origin, counts, bg, per_tile=True)
    for i in range(6):
        one = tr._composite_fwd_ref(16, geo[i:i + 1], alpha[i:i + 1], origin[i:i + 1],
                                    counts[i:i + 1], bg, per_tile=False)
        torch.testing.assert_close(per[0][i:i + 1], one[0], rtol=0, atol=1e-6)
        assert int(per[3][i]) == int(one[3][0])
    chunk = tr._composite_fwd_ref(16, geo, alpha, origin, counts, bg, per_tile=False)
    bound = tr.T_EPS * (float(geo[..., 5:8].max()) + float(bg.abs().max()))
    assert float((per[0] - chunk[0]).abs().max()) <= bound + 1e-6
    assert int(per[3].min()) < int(chunk[3].max())  # the exits did differ
    # the kernel wrapper on a CPU tensor is the per-tile plain version
    k = tr._composite_fwd_kernel(16, geo, alpha, origin, counts, bg)
    for a, b in zip(k, per):
        assert torch.equal(a, b)


def test_composite_kernel_wrappers_reject_what_they_do_not_take():
    geo, alpha, origin = _windows(c_sz=2, m=64)
    counts = torch.tensor([64, 64], dtype=torch.int32)
    bg = torch.zeros(3)
    for bm in (0, 65, 128, 48):
        with pytest.raises(ValueError):
            tr._composite_fwd_kernel(bm, geo, alpha, origin, counts, bg)
    with pytest.raises(ValueError):
        tr._composite_fwd_kernel(32, geo.double(), alpha, origin, counts, bg)
    with pytest.raises(ValueError):
        tr._composite_fwd_kernel(32, geo, alpha, origin, counts.long(), bg)
    with pytest.raises(ValueError):
        tr._composite_fwd_kernel(32, geo[:, :, :5], alpha, origin, counts, bg)


# ---------------------------------------------------------------- budgets


@pytest.mark.parametrize("saturation", [False, True])
def test_tile_occupancy_and_auto_budget_match_jax(saturation):
    c, cam = structured_scene(n=20_000)
    pc, pcam = to_port(c), to_port_camera(cam)
    cj, gj, kj = jr._tile_occupancy(c.pos, c.log_scale, c.quat, c.opacity, cam,
                                    saturation=saturation)
    ct, gt, kt = tr._tile_occupancy(t(c.pos), t(c.log_scale), t(c.quat), t(c.opacity), pcam,
                                    saturation=saturation)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert int(gt) == int(gj)
    # k_sat may differ by one where an f32 prefix lands within rounding of
    # log(T_EPS) (torch and XLA form the cumulative sum in another order)
    assert np.abs(kt.numpy() - np.asarray(kj)).max() <= 1
    for kw in (dict(cap=16384, glob_cap=1024, band_chunk=4), dict(cap=32), dict()):
        bj = jr.auto_budget(c, cam, saturation=saturation, **kw)
        bt = tr.auto_budget(pc, pcam, saturation=saturation, device="cpu", **kw)
        assert sorted(bj) == sorted(bt)
        for k in bj:
            if k == "tile_order":
                np.testing.assert_array_equal(bt[k], bj[k])
            else:
                assert bt[k] == bj[k], (k, bt[k], bj[k])


def test_plan_bands_matches_jax():
    needed = np.random.default_rng(3).integers(0, 3000, 510)
    for chunk, cap in ((1, 1024), (8, 4096), (64, 256)):
        oj, pj = jr.plan_bands(needed, tile_chunk=chunk, cap=cap)
        ot, pt = tr.plan_bands(needed, tile_chunk=chunk, cap=cap)
        np.testing.assert_array_equal(ot, oj)
        assert pt == pj and ot.dtype == np.int32


# ------------------------------------------------------------------- train


def test_fit_matches_jax_over_five_steps():
    from gsconverter_tpu.render.train import fit as j_fit
    from gsconverter_tpu.render.train import params_of as j_params
    from gsconverter_tpu_torch.render import train as tt

    c, cam = scene(n=120)
    target = jr.render(c, cam)
    perturbed = c.replace(sh_dc=c.sh_dc + 0.3, opacity=c.opacity - 0.5)
    kw = dict(max_per_tile=128)
    # step-0 gradients
    p0 = j_params(perturbed)
    g0 = jax.grad(lambda p: jnp.mean((jr.render(perturbed.replace(**p), cam, **kw)
                                      - target) ** 2))(p0)
    base = to_port(perturbed).to_device("cpu")
    params = {k: v.detach().clone().requires_grad_(True) for k, v in tt.params_of(base).items()}
    opt = torch.optim.Adam(list(params.values()), lr=2e-2, betas=(0.9, 0.999), eps=1e-8)
    step = tt.make_train_step(base, to_port_camera(cam), opt, params, **kw)
    step(torch.from_numpy(np.array(target)))
    for k in tt.TRAINABLE:
        assert rel_err(params[k].grad.numpy(), g0[k]) <= 1e-4, k
    norms = torch.linalg.norm(params["quat"].detach(), dim=-1)
    torch.testing.assert_close(norms, torch.ones_like(norms))
    # five steps: the losses agree (parameters are not compared: Adam's
    # first step moves each by +-lr on its gradient's sign)
    _, lj = j_fit(perturbed, cam, target, steps=5, lr=2e-2, **kw)
    fitted, lt = tt.fit(to_port(perturbed), to_port_camera(cam), np.asarray(target),
                        steps=5, lr=2e-2, device="cpu", **kw)
    np.testing.assert_allclose(lt, lj, rtol=1e-3)
    assert isinstance(fitted.pos, torch.Tensor) and not fitted.pos.requires_grad


def test_fit_reduces_loss():
    from gsconverter_tpu_torch.render.train import fit

    c, cam = scene(n=120)
    pc, pcam = to_port(c), to_port_camera(cam)
    target = tr.render(pc, pcam, device="cpu")
    perturbed = pc.replace(sh_dc=pc.sh_dc + 0.3, opacity=pc.opacity - 0.5)
    _, losses = fit(perturbed, pcam, target, steps=30, lr=2e-2, max_per_tile=128,
                    device="cpu")
    assert losses[-1] < losses[0] * 0.5


# ------------------------------------------------------- verification, device


def test_conversion_verified_by_rendered_psnr(tmp_path):
    """The north-star check through the port's spz codec: above 30 dB, and
    within 0.1 dB of the JAX package's own."""
    from gsconverter_tpu.formats import get_handler as j_handler
    from gsconverter_tpu_torch.formats import get_handler as t_handler

    c, cam = scene(n=400)
    pc, pcam = to_port(c), to_port_camera(cam)
    t_handler("spz").write(pc, str(tmp_path / "t.spz"))
    back = t_handler("spz").read(str(tmp_path / "t.spz"))
    p_port = float(tr.psnr(tr.render(pc, pcam, device="cpu"),
                           tr.render(back, pcam, device="cpu")))
    j_handler("spz").write(c, str(tmp_path / "j.spz"))
    jb = j_handler("spz").read(str(tmp_path / "j.spz"))
    p_jax = float(jr.psnr(jr.render(c, cam), jr.render(jb, cam)))
    assert p_port > 30.0
    assert abs(p_port - p_jax) <= 0.1, (p_port, p_jax)


def test_render_of_a_host_cloud_needs_the_card_unless_told(monkeypatch):
    c, cam = scene(n=50)
    pc, pcam = to_port(c), to_port_camera(cam)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tr.render, tr.render_reference, tr.auto_budget):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(pc, pcam)
    from gsconverter_tpu_torch.render.train import fit

    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(pc, pcam, np.zeros((64, 64, 3), np.float32), steps=1)
    # a tensor cloud renders where it lives; a conflicting device raises
    img = tr.render(pc.to_device("cpu"), pcam)
    assert img.device.type == "cpu"
    with pytest.raises(ValueError):
        tr.render(pc.to_device("cpu"), pcam, device="cuda")
    with pytest.raises(ValueError):
        tr.render(pc, pcam, binning="tiles", device="cpu")
