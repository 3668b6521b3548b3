"""The reference's work counts against brute force, its imports, and the
roofline and its readers on made-up traces."""

import ast
import itertools
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsbench import spec, trace
from gsbench.reference import convert as ref_convert
from gsbench.reference import render as ref_render


def _scene(n, seed=5):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(n, 10, generator=g)
    return {"pos": z[:, 0:3] * 0.3, "sh_dc": z[:, 3:6] * 0.5,
            "sh_rest": torch.zeros(n, 3, 15), "opacity": z[:, 6] + 1.0,
            "log_scale": z[:, 7:10] * 0.3 - 3.0,
            "quat": torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(n, 1)}


RCFG = {"block_m": 8, "budget": {"cap": 64, "glob_cap": 32, "max_mid": 16384}}


def test_composite_pairs_equal_a_brute_force_count():
    """K5's and K6's needed pairs: (candidate, pixel) pairs with alpha >=
    1/255 while the pixel's transmittance exceeds 1e-4, each tile stopping
    at a block boundary once no pixel's does."""
    p = _scene(400)
    cam = ref_render.Camera([0, 0, 3.0], [0, 0, 0], [0, 1, 0], 60.0, 48, 32, "cpu")
    proj = ref_render.project(p, cam, 0)
    budget, glob = ref_render.budgets(proj, cam, RCFG["budget"])
    frame = ref_render.Frame(proj, cam, budget, glob, RCFG)
    work: dict = {}
    frame.image(proj, work=work)
    packed = torch.cat([proj["means2d"], proj["conic"], proj["color"]], 1).detach().double()
    alpha = proj["alpha"].detach().double()
    pairs = rows = 0
    bm = RCFG["block_m"]
    for tt, idx, ok, cnt in frame.groups:
        ids = frame.s_ids[idx]
        for c in range(len(tt)):
            t = int(tt[c])
            ox, oy = (t % frame.tw) * 16, (t // frame.tw) * 16
            gx, gy = np.meshgrid(np.arange(16) + ox + 0.5, np.arange(16) + oy + 0.5)
            T = np.ones(256)
            for j in range(min(int(cnt[c]), ids.shape[1])):
                if j % bm == 0 and T.max() <= ref_render.T_EPS:
                    break
                if not ok[c, j]:
                    continue
                mx, my, ca, cb, cc = packed[ids[c, j], :5].tolist()
                dx, dy = gx.ravel() - mx, gy.ravel() - my
                power = -0.5 * (ca * dx * dx + 2 * cb * dx * dy + cc * dy * dy)
                a = np.minimum(float(alpha[ids[c, j]]) * np.exp(np.minimum(power, 0)), 0.99)
                a = np.where(a < 1 / 255, 0.0, a)
                live = (a > 0) & (T > ref_render.T_EPS)
                pairs += int(live.sum())
                rows += bool(live.any())
                T = T * (1 - a)
    assert work["pairs"] > 0
    assert abs(work["pairs"] - pairs) <= 1e-4 * pairs and abs(work["rows"] - rows) <= 1


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_color_agrees_with_the_port_and_with_its_own_band_sums(degree):
    """The reference's view-dependent color against the port's ``eval_sh``
    (a test may import both; the reference does not), and degree 3 against
    the 16 basis functions written out as one dot product."""
    from gsconverter_tpu_torch.cloud import SplatCloud
    from gsconverter_tpu_torch.ops.sh import eval_sh

    g = torch.Generator().manual_seed(11)
    n = 257
    p = {"sh_dc": torch.randn(n, 3, generator=g), "sh_rest": torch.randn(n, 3, 15, generator=g)}
    p["sh_rest"][:, :, {0: 0, 1: 3, 2: 8, 3: 15}[degree]:] = 0.0
    d = torch.randn(n, 3, generator=g)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    got = ref_render.sh_color(p, d, degree)
    z = torch.zeros(n, 3)
    cloud = SplatCloud(pos=z, sh_dc=p["sh_dc"], sh_rest=p["sh_rest"], opacity=z[:, 0],
                       log_scale=z, quat=torch.zeros(n, 4), normal=z, active_sh_degree=degree)
    torch.testing.assert_close(got, eval_sh(cloud, d, degree), rtol=1e-5, atol=1e-5)
    x, y, zz = d[:, 0].double(), d[:, 1].double(), d[:, 2].double()
    c1, c2, c3 = ref_render.SH_C1, ref_render.SH_C2, ref_render.SH_C3
    basis = torch.stack([
        -c1 * y, c1 * zz, -c1 * x,
        c2[0] * x * y, c2[1] * y * zz, c2[2] * (2 * zz * zz - x * x - y * y), c2[3] * x * zz,
        c2[4] * (x * x - y * y),
        c3[0] * y * (3 * x * x - y * y), c3[1] * x * y * zz,
        c3[2] * y * (4 * zz * zz - x * x - y * y),
        c3[3] * zz * (2 * zz * zz - 3 * x * x - 3 * y * y),
        c3[4] * x * (4 * zz * zz - x * x - y * y), c3[5] * zz * (x * x - y * y),
        c3[6] * x * (x * x - 3 * y * y)], 1)
    want = 0.5 + ref_render.SH_C0 * p["sh_dc"].double() + (p["sh_rest"].double()
                                                          * basis[:, None, :]).sum(-1)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def test_sor_window_pairs_and_means_equal_a_brute_force():
    """K1's needed pairs (each point with every other row of its block's
    window) and the mean distance to the k nearest among them."""
    rng = np.random.default_rng(3)
    pos = rng.normal(0, 1, (1100, 3)).astype(np.float32)
    k, window = 10, 256
    md, pairs = ref_convert.sor_mean_dists(pos, k, window, "cpu")
    n, want = len(pos), 0
    for b0 in range(0, n, 512):
        rows = min(512, n - b0)
        want += rows * (min(n, b0 + 512 + window) - max(0, b0 - window) - 1)
    assert pairs == want
    # brute force in the same Morton order
    p = torch.from_numpy(pos)
    lo, hi = p.amin(0), p.amax(0)
    g = (torch.clamp((p - lo) / (hi - lo), 0, 1) * 511.0).long()
    order = torch.sort(ref_convert._morton(g), stable=True).indices.numpy()
    sp = pos[order].astype(np.float64)
    for r in (0, 511, 512, 1099):
        b0 = r // 512 * 512
        cand = np.arange(max(0, b0 - window), min(n, b0 + 512 + window))
        d = np.sort(np.linalg.norm(sp[cand] - sp[r], axis=1)[cand != r])[:k]
        assert math.isclose(md[order[r]], d.mean(), rel_tol=1e-12)


def test_roofline_readers_count_and_refuse_mismatched_launches():
    tr = trace.Trace(iterations=2, window_s=0.01,
                     device=[("composite_fwd_kernel(float const*)", 0.0, 500.0),
                             ("composite_fwd_kernel(float const*)", 1000.0, 500.0),
                             ("void at::elementwise_kernel<1>()", 600.0, 100.0)],
                     host=[("aten::add", 550.0, 200.0, "cpu_op")],
                     launches={"composite_fwd": 2}, work={"k5": {"ops": 33.5e6, "bytes": 0}})
    assert trace.roofline_share(tr, "composite_fwd_kernel", "composite_fwd", "k5") \
        == pytest.approx(100.0 * 1e-6 / 1e-3)
    assert trace.device_ms_besides(tr, {"composite_fwd_kernel": "composite_fwd"}) \
        == pytest.approx(0.05)
    assert trace.idle_share(tr) == pytest.approx(100 * (1 - 1.1e-3 / 0.01))
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert gaps["aten::add"] == pytest.approx(1e-4) and len(gaps) == 2
    tr.launches["composite_fwd"] = 3  # the profiler dropped a launch
    assert trace.roofline_share(tr, "composite_fwd_kernel", "composite_fwd", "k5") is None


def _roofline_s_before(ops, nbytes):
    """The roofline before it counted tensor-core work."""
    return max(ops / 33.5e12, nbytes / 3.35e12)


GRID = [0.0, 1.0, 3.3e5, 7.7e9, 2.1e12, 5.0e15]


def test_roofline_without_tensor_core_work_is_the_formula_before():
    for ops, nbytes in itertools.product(GRID, GRID):
        assert trace.roofline_s(ops, nbytes) == _roofline_s_before(ops, nbytes)
        assert trace.roofline_s(ops, nbytes, 0.0) == _roofline_s_before(ops, nbytes)


def test_the_tensor_core_term_wins_only_where_it_is_largest():
    assert trace.BF16_TC_FLOP_PER_S == 989e12
    for ops, nbytes, tc in itertools.product(GRID, GRID, GRID):
        before, tc_s = _roofline_s_before(ops, nbytes), tc / 989e12
        assert trace.roofline_s(ops, nbytes, tc) == (tc_s if tc_s > before else before)


# each roofline reader of the cells: (its kernel, the port's counter,
# its work entry)
READERS = {"k1_roofline.convert": ("sor_window_md_kernel", "k1", "k1"),
           "k5_roofline.train": ("composite_fwd_kernel", "composite_fwd", "k5"),
           "k6_roofline.train": ("composite_bwd_kernel", "composite_bwd", "k6"),
           "k5_roofline.frame": ("composite_fwd_kernel", "composite_fwd", "k5")}


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("ops,nbytes", [(2.3e9, 1.1e7), (4.0e6, 9.6e8)])
def test_roofline_readers_read_what_they_read_before(name, ops, nbytes):
    """On a made-up trace, bound by the operations and by the bytes: the
    share of the formula before, to the last bit."""
    function, counter, key = READERS[name]
    tr = trace.Trace(iterations=3, window_s=0.05,
                     device=[(f"void (anonymous namespace)::{function}<32, 256>(float const*)",
                              100.0, 400.0),
                             ("void at::elementwise_kernel<1>()", 600.0, 100.0),
                             (f"void (anonymous namespace)::{function}<32, 256>(float const*)",
                              900.0, 700.0)],
                     host=[], launches={counter: 2}, work={key: {"ops": ops, "bytes": nbytes}})
    got = spec.metric_reader(name).read(tr)
    assert got == 100.0 * _roofline_s_before(ops, nbytes) / ((400.0 + 700.0) * 1e-6)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_port_or_jax():
    banned = {"gsconverter_tpu_torch", "gsconverter_tpu", "jax", "jaxlib", "flax"}
    for path in (spec.GSBENCH / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & banned, (path.name, tops & banned)
    code = ("import sys; import gsbench.reference.render, gsbench.reference.convert; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gsconverter_tpu_torch', 'gsconverter_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
