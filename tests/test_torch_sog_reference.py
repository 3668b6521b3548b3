""".sog files of the PyTorch port against the benchmark's plain SOG reference
(``gsbench/reference/sog.py``), on the CPU at the tiny size of the cell
``c3-sog-l1``: 20,000 splats at SH degree 2, and compression level 10 in
the place of the cell's 1, so that a palette entry holds about 10 splats (at
level 1 it would hold 2; the cell's own 3M splats give 64 an entry), enough
for the palette's error to settle as at the cell's size.

A sound file reads under every limit of the cell; the reference in
bfloat16 (the control) and each fault of the ``sog`` kind read over at
least one.  The writer's exact stages give the same order and bytes from a
tensor as from numpy, and the cell's readers read the port's spans and the
device trace.  The JAX package's parity of the whole file is
``test_torch_sog.py``'s.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsbench import common, faults, scene, spec, trace
from gsbench.reference import sog as ref
from gsbench.tiny import tiny_cell
from gsconverter_tpu_torch.converter import Converter
from gsconverter_tpu_torch.formats import get_handler
from gsconverter_tpu_torch.formats import sog as tsog
from gsconverter_tpu_torch.utils import log, transfer

CELL = "c3-sog-l1"
SEED = 2**31 + 23


@pytest.fixture(scope="module")
def cell():
    return tiny_cell(CELL)


@pytest.fixture(scope="module")
def source(cell, tmp_path_factory):
    """The cell's tiny scene from the seed, as the loop writes it, and the
    reference's encode of it."""
    host = scene.to_host(scene.mint(cell.config["scene"], SEED, "cpu"))
    path = tmp_path_factory.mktemp("sog") / "scene.ply"
    scene.write_ply(str(path), host)
    expected = ref.expected(host, cell.traffic["compression_level"],
                            cell.config["scene"]["sh_degree"], SEED, "cpu")
    return host, str(path), expected


def _numbers(cell, source, out):
    host, src, expected = source
    Converter(src, out, "sog", device="cpu").run(
        compression_level=cell.traffic["compression_level"], **cell.config["filters"])
    return ref.compare(ref.decode(out), expected, cell.traffic["compression_level"])


def _over(numbers, limits):
    return [k for k, v in numbers.items() if not v <= limits[k]]


def test_the_port_reads_under_every_limit(cell, source, tmp_path):
    numbers = _numbers(cell, source, str(tmp_path / "out.sog"))
    assert set(numbers) == set(cell.limits)
    assert _over(numbers, cell.limits) == [], numbers


def test_the_bfloat16_control_reads_over_a_limit(cell, source):
    host, _, expected = source
    level = cell.traffic["compression_level"]
    low = ref.expected(common.bf16(host), level, cell.config["scene"]["sh_degree"], SEED, "cpu")
    numbers = ref.compare(low, expected, level)
    assert "pos_steps" in _over(numbers, cell.limits), numbers


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered", "fit_stalled",
                                   "labels_shifted"])
def test_a_fault_reads_over_a_limit(cell, source, fault, tmp_path, monkeypatch):
    assert fault in faults.names("sog")
    faults.plant(cell, fault, monkeypatch.setattr)
    numbers = _numbers(cell, source, str(tmp_path / "out.sog"))
    assert _over(numbers, cell.limits), numbers


def test_the_reference_and_the_loop_load_neither_jax_nor_the_jax_package(tmp_path):
    code = f"""
import json, sys
import torch
torch.set_num_threads(2)
from gsbench import scene, spec
from gsbench.reference import sog as ref
from gsbench.faults import sog as sog_faults
loop = spec.traffic_loop("sog")
from gsconverter_tpu_torch.converter import Converter
cfg = dict(splats=3000, pos_sigma=2.0, sh_degree=2, sh_dc_sigma=0.5, sh_rest_sigma=0.1,
           opacity_mean=1.0, opacity_sigma=2.0, log_scale_mean=-4.0, log_scale_sigma=0.5,
           rotation="random")
host = scene.to_host(scene.mint(cfg, 5, "cpu"))
scene.write_ply({str(tmp_path / "s.ply")!r}, host)
Converter({str(tmp_path / "s.ply")!r}, {str(tmp_path / "o.sog")!r}, "sog",
          device="cpu").run(compression_level=1)
got = ref.compare(ref.decode({str(tmp_path / "o.sog")!r}), ref.expected(host, 1, 2, 5, "cpu"), 1)
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps([got["pos_steps"], [m for m in top if m in ("jax", "jaxlib", "gsconverter_tpu")],
                  hasattr(loop, "Loop")]))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    pos_steps, found, has_loop = json.loads(res.stdout.strip().splitlines()[-1])
    assert pos_steps <= 1 and found == [] and has_loop


# ------------------------------------------------- the exact stages, numpy and tensor


def _rest(n, degree, rng):
    """sh_rest's degree-packed [n, 3, coeffs // 3] slice with values on the
    u8 grid's rounding edges: each row a multiple of 97 sets the bounds."""
    per = (degree + 1) ** 2 - 1
    rest = rng.normal(0, 0.1, (n, 3, per)).astype(np.float32)
    rest[0], rest[97] = -0.5, 0.5
    rest[1:97] = np.clip(rest[1:97], -0.45, 0.45)
    rest[98:] = np.clip(rest[98:], -0.45, 0.45)
    lo, hi = np.float32(-0.5), np.float32(0.5)
    scale = (float(hi) - float(lo)) / 255.0
    edges = np.float32(lo) + (np.arange(255) + 0.5).astype(np.float32) * np.float32(scale)
    edge = np.concatenate([edges, np.nextafter(edges, np.float32(1)),
                           np.nextafter(edges, np.float32(-1))])
    flat = rest.reshape(-1)
    at = np.setdiff1d(np.arange(flat.size), np.arange(0, n, 97)[:, None] * 3 * per
                      + np.arange(3 * per))[:edge.size * 4]
    flat[at] = np.resize(edge, at.size)
    return rest


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_morton_order_and_shn_u8_agree_on_a_tensor_and_numpy(degree):
    rng = np.random.default_rng(degree)
    n = 6000
    pos = rng.normal(0, 2, (n, 3)).astype(np.float32)
    pos[:300] = pos[300:600]  # tied Morton codes keep their source order
    pos[600:700] = pos[700]
    pos[701, 0] = pos[:, 0].max() + 1.0  # a point on a bound
    want = tsog.morton_order(pos)
    got = tsog.morton_order(torch.from_numpy(pos))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)

    per = (degree + 1) ** 2 - 1
    rest = _rest(n, degree, rng)
    q8, scale, mn = tsog.shn_u8(rest, n, 3 * per)
    tq8, tscale, tmn = tsog.shn_u8(torch.from_numpy(rest), n, 3 * per)
    assert (tscale, tmn) == (scale, mn)
    assert tq8.dtype == torch.uint8
    np.testing.assert_array_equal(tq8.numpy(), q8)
    # the edges do land on both sides of a step
    assert len(np.unique(q8)) == 256
    np.testing.assert_array_equal(tq8[torch.from_numpy(want)].numpy(), q8[want])


def test_a_ply_reads_fields_go_to_the_device_as_one_record_block(tmp_path):
    cfg = dict(splats=3000, pos_sigma=2.0, sh_degree=2, sh_dc_sigma=0.5, sh_rest_sigma=0.1,
               opacity_mean=1.0, opacity_sigma=2.0, log_scale_mean=-4.0, log_scale_sigma=0.5,
               rotation="random")
    scene.write_ply(str(tmp_path / "s.ply"), scene.to_host(scene.mint(cfg, 7, "cpu")))
    cloud = get_handler("3dgs").read(str(tmp_path / "s.ply"))
    fields = {"pos": cloud.pos, "log_scale": cloud.log_scale, "sh_dc": cloud.sh_dc,
              "rest": np.asarray(cloud.sh_rest)[:, :, :8], "quat": cloud.quat,
              "opacity": cloud.opacity, "own": np.arange(12.0, dtype=np.float32).reshape(4, 3)[::2]}
    out = transfer.upload_fields(fields, "cpu")
    for name, a in fields.items():
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(a))
    # the strided views of the vertex records share one block; the others
    # (contiguous, or a view of no record buffer) are their own copies
    views = {out[k].untyped_storage().data_ptr() for k in ("log_scale", "sh_dc", "rest", "quat")}
    assert len(views) == 1
    assert out["rest"].stride() == (62, 15, 1)
    others = {out[k].untyped_storage().data_ptr() for k in ("pos", "opacity", "own")}
    assert len(others) == 3 and not others & views


# ---------------------------------------------------------------- the cell's readers


def _span(name, id_, parent, root, ms, **counts):
    return log.SpanRecord(name, id_, parent, root, 0, int(ms * 1e6), True, counts)


def _synthetic():
    """Two conversions under the profiler, and one recorded without it."""
    out = []
    for r, (base, waits) in enumerate(((10, 40), (30, 44))):
        root = 100 * (r + 1)
        out.append(_span("convert", root, None, root, 5000.0, host_waits=waits))
        out.append(_span("write", root + 1, root, root, 3000.0))
        for i, stage in enumerate(("sog.upload", "sog.morton_order", "sog.shN_quant_u8",
                                   "sog.encode_threads_join", "sog.shN_fit+centroids_pull",
                                   "sog.webp_flush")):
            out.append(_span(stage, root + 2 + i, root + 1, root, base + i))
    out.append(log.SpanRecord("convert", 900, None, 900, 0, 10**9, False, {"host_waits": 99}))
    return out


SPAN_READERS = {"upload_ms.sog": 20.0, "morton_ms.sog": 21.0, "shn_quant_ms.sog": 22.0,
                "encode_join_ms.sog": 23.0, "palette_wait_ms.sog": 24.0,
                "webp_wait_ms.sog": 25.0, "host_waits.sog": 42.0}


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_a_span_reader_reads_the_mean_a_conversion(name, monkeypatch):
    read = spec.metric_reader(name).read
    monkeypatch.setattr(log, "spans", lambda: [])
    assert read(None) is None
    monkeypatch.setattr(log, "spans", _synthetic)
    assert read(None) == pytest.approx(SPAN_READERS[name], rel=1e-12)


def _trace(k2_launches=22, k4_launches=22):
    """Two conversions' K2 and K4 kernels: 1 ms of labels and 0.25 ms of
    re-check a K2 launch, 0.5 ms over K4's kernels a launch."""
    dev = []
    for i in range(k2_launches):
        dev += [("void lloyd_labels_tc_kernel<64>(float const*)", 10.0 * i, 1000.0),
                ("lloyd_recheck_kernel(float const*)", 10.0 * i + 1, 250.0)]
    for i in range(k4_launches):
        dev += [("radix_hist_kernel(int const*)", 0.0, 100.0),
                ("void row_scan_kernel<false, 1024>(int*)", 0.0, 100.0),
                ("cluster_starts_kernel(int const*)", 0.0, 50.0),
                ("piece_sums_kernel(float const*)", 0.0, 250.0)]
    dev.append(("at::native::elementwise_kernel", 0.0, 5000.0))
    work = spec.traffic_loop("sog").k2_k4_work(3_000_000, 64, 1024, 24, 22)
    return trace.Trace(iterations=2, window_s=1.0, device=dev, host=[],
                       launches={"k2": 22, "k4": 22}, work=work)


def test_the_k2_and_k4_work_at_the_cell_size():
    work = spec.traffic_loop("sog").k2_k4_work(3_000_000, 64, 1024, 24, 11)
    assert work["k2"]["tc_flops"] == 2.0 * 3_000_000 * 1024 * 24 * 11
    # a launch: the products on the tensor cores bound K2 (0.149 ms)
    assert trace.roofline_s(0.0, work["k2"]["bytes"] / 11, work["k2"]["tc_flops"] / 11) \
        == pytest.approx(2.0 * 3e6 * 1024 * 24 / trace.BF16_TC_FLOP_PER_S)
    assert work["k4"]["bytes"] == 11 * (3e6 * 24 * 4 + 3e6 * 4 + 65536 * 25 * 4)


def test_the_k2_and_k4_rooflines_read_their_kernels():
    tr = _trace()
    w = tr.work
    k2 = spec.metric_reader("k2_roofline.sog").read(tr)
    assert k2 == pytest.approx(100.0 * w["k2"]["tc_flops"] / trace.BF16_TC_FLOP_PER_S
                               / (22 * 1.25e-3), rel=1e-9)
    k4 = spec.metric_reader("k4_roofline.sog").read(tr)
    assert k4 == pytest.approx(100.0 * w["k4"]["bytes"] / trace.HBM_BYTES_PER_S
                               / (22 * 0.5e-3), rel=1e-9)
    # a launch the profiler missed, or a port without the counter: nothing
    for name in ("k2_roofline.sog", "k4_roofline.sog"):
        assert spec.metric_reader(name).read(_trace(k2_launches=21, k4_launches=21)) is None
        bare = _trace()
        bare.launches = {}
        assert spec.metric_reader(name).read(bare) is None
