"""The port's spans and counters (``utils/log.py``, ``utils/transfer.py``)
and the benchmark's readers of them.

The CPU tests run a tiny render, training step and conversions.  The one
card test renders a frame of BASELINE config 4's shape under the profiler
and holds the host's counted waits against the copies of the device trace.
The module imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py
"""

import gzip
import json
import sys
import types
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsconverter_tpu_torch import config
from gsconverter_tpu_torch.cloud import SplatCloud
from gsconverter_tpu_torch.converter import Converter
from gsconverter_tpu_torch.formats import get_handler
from gsconverter_tpu_torch.render import rasterizer as rz
from gsconverter_tpu_torch.render import train
from gsconverter_tpu_torch.utils import log, transfer

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: how far a span may lie from its range in an exported trace (us)
CLOCK_US = 100.0


def _scene(n=1500, seed=3, sh_degree=3):
    r = np.random.default_rng(seed)
    quat = r.normal(0, 1, (n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    rest = np.zeros((n, 3, 15), np.float32)
    k = (sh_degree + 1) ** 2 - 1
    rest[:, :, :k] = r.normal(0, 0.1, (n, 3, k))
    return SplatCloud(pos=r.normal(0, 1, (n, 3)).astype(np.float32),
                      sh_dc=r.normal(0, 0.5, (n, 3)).astype(np.float32), sh_rest=rest,
                      opacity=r.normal(0, 1, n).astype(np.float32),
                      log_scale=r.normal(-3, 0.3, (n, 3)).astype(np.float32), quat=quat,
                      normal=np.zeros((n, 3), np.float32), active_sh_degree=sh_degree)


def _render_kw(cloud, cam, tile_chunk=2, block_m=32):
    b = rz.auto_budget(cloud, cam, band_chunk=tile_chunk, device="cpu")
    return dict(max_global=b["max_global"], tile_chunk=tile_chunk, block_m=block_m,
                tile_order=b["tile_order"], band_plan=b["band_plan"])


@pytest.fixture
def frame():
    cloud = _scene().to_device("cpu")
    cam = rz.Camera.look_at((0, 0, 5), (0, 0, 0), width=64, height=48)
    return cloud, cam, _render_kw(cloud, cam)


@pytest.fixture
def fresh():
    """An empty span buffer, tracing off to start with."""
    prev = config.TIMING
    config.TIMING = False
    log.clear_spans()
    yield
    config.TIMING = prev
    log.clear_spans()


def _step(cloud, cam, kw):
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in train.params_of(cloud).items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-3)
    return train.make_train_step(cloud, cam, opt, params, **kw)


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id), key=lambda s: s.start_ns)


def _expected_slots(kw, n, on_card):
    """Sum over the launch groups of tiles x budget padded to block_m."""
    groups = rz._launch_groups((48 // 16) * (64 // 16), kw["tile_chunk"], on_card, True, 256,
                               n, kw["tile_order"], kw["band_plan"])
    bm = kw["block_m"]
    return sum(len(ids) * (b + -b % bm) for _, ids, b in groups if len(ids)), len(groups)


# ------------------------------------------------------------------- off


def test_spans_record_nothing_while_tracing_is_off(frame, fresh):
    cloud, cam, kw = frame
    assert log.span("a") is log.span("b", n=1)  # the shared no-op context
    with torch.no_grad():
        rz.render(cloud, cam, **kw)
    _step(cloud, cam, kw)(torch.zeros(48, 64, 3))
    log.count(host_waits=1)
    assert log.spans() == []


# ------------------------------------------------------------ span trees


def test_render_under_the_profiler_is_one_tree_with_its_counters(frame, fresh):
    cloud, cam, kw = frame
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        rz.render(cloud, cam, **kw)
    spans = log.spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "render" and root.profiled
    assert {s.root for s in spans} == {root.id}
    names = [s.name for s in _children(spans, root)]
    bands = [s for s in _children(spans, root) if s.name == "band"]
    assert names == ["project", "sh_color", "bin"] + ["band"] * len(bands) + ["assemble"]
    for b in bands:
        # the CPU copies no data to a card: no ``wait`` under a band
        assert [s.name for s in _children(spans, b)] == ["gather", "composite"]
        assert b.counts["slots"] == b.counts["tiles"] * b.counts["budget"]
        assert b.counts["budget"] % kw["block_m"] == 0
    slots, n_groups = _expected_slots(kw, cloud.n, on_card=False)
    assert root.counts["bands"] == len(bands) == n_groups
    assert root.counts["window_slots"] == sum(b.counts["slots"] for b in bands) == slots
    assert "host_waits" not in root.counts


def test_train_step_under_the_profiler_is_one_tree_with_its_counters(frame, fresh):
    cloud, cam, kw = frame
    step = _step(cloud, cam, kw)
    with profile(activities=[ProfilerActivity.CPU]):
        step(torch.zeros(48, 64, 3))
    spans = log.spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "train_step"
    assert {s.root for s in spans} == {root.id}
    top = _children(spans, root)
    assert [s.name for s in top] == ["optimizer", "render", "loss", "backward", "optimizer"]
    render, backward = top[1], top[3]
    bands = [s for s in _children(spans, render) if s.name == "band"]
    bwd = _children(spans, backward)
    assert [s.name for s in bwd] == ["composite_bwd"] * len(bands)
    # each band's backward carries that band's counters
    key = lambda s: (s.counts["tiles"], s.counts["budget"], s.counts["slots"])  # noqa: E731
    assert sorted(map(key, bwd)) == sorted(map(key, bands))
    assert root.counts["bands"] == render.counts["bands"] == len(bands)
    assert root.counts["window_slots"] == render.counts["window_slots"]


@pytest.mark.parametrize("on_card", [False, True])
def test_window_slots_is_the_band_plans_tiles_times_padded_budget(frame, fresh, monkeypatch,
                                                                  on_card):
    """On the CPU a group is ``tile_chunk`` tiles, pads included; on the
    card a band's real tiles (routed here through the card's grouping)."""
    cloud, cam, kw = frame
    groups = rz._launch_groups
    monkeypatch.setattr(rz, "_launch_groups",
                        lambda n_tiles, chunk, _, *a: groups(n_tiles, chunk, on_card, *a))
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        rz.render(cloud, cam, **kw)
    (root,) = [s for s in log.spans() if s.parent is None]
    slots, n_groups = _expected_slots(kw, cloud.n, on_card)
    assert root.counts["window_slots"] == slots and root.counts["bands"] == n_groups
    if on_card:
        # one band a plan entry, its real tiles at the plan's budget
        n_tiles = (48 // 16) * (64 // 16)
        order = np.asarray(kw["tile_order"])
        want, at = 0, 0
        for chunks, mb in kw["band_plan"]:
            ids = order[at:at + chunks * kw["tile_chunk"]]
            at += chunks * kw["tile_chunk"]
            want += int((ids < n_tiles).sum()) * (mb + -mb % kw["block_m"])
        assert slots == want and n_groups == len(kw["band_plan"])


# ----------------------------------------------------------------- clock


def _ranges(path):
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    out = defaultdict(list)
    for ev in trace["traceEvents"]:
        # a span's range: a function-scope one (``cpu_op``), or a
        # ``record_function`` annotation where torch lacks that
        if (ev.get("cat") in ("cpu_op", "user_annotation")
                and ev["name"].startswith("gsconverter/")):
            start = ev["ts"] * 1000.0 + base
            out[ev["name"][len("gsconverter/"):]].append((start, start + ev["dur"] * 1000.0))
    return {k: sorted(v) for k, v in out.items()}


def _worst_clock_us(spans, path):
    """The largest gap (us) between a span's start or end and its range's."""
    ranges = _ranges(path)
    by = defaultdict(list)
    for s in spans:
        by[s.name].append(s)
    worst = 0.0
    for name, mine in by.items():
        mine.sort(key=lambda s: s.start_ns)
        assert len(ranges[name]) == len(mine), name
        for s, (a, b) in zip(mine, ranges[name]):
            worst = max(worst, abs(s.start_ns - a) / 1e3, abs(s.end_ns - b) / 1e3)
    return worst


def test_a_span_agrees_with_its_range_in_the_exported_trace(frame, fresh, tmp_path):
    """To ``CLOCK_US``.  A shared host may preempt the process between the
    profiler's clock read and the span's, so the best of three tries
    counts."""
    cloud, cam, kw = frame
    worst = []
    for attempt in range(3):
        log.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
            rz.render(cloud, cam, **kw)
        path = tmp_path / f"trace{attempt}.json"
        prof.export_chrome_trace(str(path))
        worst.append(_worst_clock_us(log.spans(), path))
        if worst[-1] <= CLOCK_US:
            break
    assert min(worst) <= CLOCK_US, worst


# ------------------------------------------------------------- transfers


def test_transfers_count_a_card_copy_and_skip_a_host_one(fresh, monkeypatch):
    t = torch.arange(6, dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU]):
        with log.span("host"):
            assert transfer.to_host(t).tolist() == list(range(6))
            transfer.upload(t.numpy(), "cpu")
            transfer.synchronize("cpu")
    (host,) = log.spans()
    assert host.counts == {}
    log.clear_spans()
    # the device check says "card": the same calls are waits
    monkeypatch.setattr(transfer, "_is_card", lambda dev: torch.device(dev).type == "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        with log.span("outer"):
            assert transfer.to_host(t).tolist() == list(range(6))
            u = transfer.upload(np.arange(4, dtype=np.int64), "cpu")
            transfer.upload(u, "cpu")  # already on the "card": no copy
            transfer.to_host(np.ones(3))  # host data passes through
    assert u.tolist() == [0, 1, 2, 3]
    spans = log.spans()
    waits = [s for s in spans if s.name == "wait"]
    (outer,) = [s for s in spans if s.name == "outer"]
    assert len(waits) == 2 and all(w.parent == outer.id for w in waits)
    assert [w.counts for w in waits] == [{"host_waits": 1, "wait_bytes": 24},
                                         {"host_waits": 1, "wait_bytes": 32}]
    assert outer.counts == {"host_waits": 2, "wait_bytes": 56}


def test_a_thread_without_spans_of_its_own_joins_the_last_opened(fresh):
    import threading

    config.TIMING = True
    with log.span("step") as step:
        t = threading.Thread(target=lambda: log.span("worker").__enter__().__exit__(None, None, None))
        t.start()
        t.join()
    (worker,) = [s for s in log.spans() if s.name == "worker"]
    assert worker.parent == step.id and worker.root == step.id


def test_counts_from_many_threads_lose_no_update(fresh, monkeypatch):
    """More threads than cores, a short switch interval: every wait and
    every count arrives."""
    import os
    import threading

    monkeypatch.setattr(transfer, "_is_card", lambda dev: torch.device(dev).type == "cpu")
    t = torch.ones(2, dtype=torch.float32)
    n_threads, per = 2 * (os.cpu_count() or 4), 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        config.TIMING = True
        with log.span("step") as step:
            workers = [threading.Thread(target=lambda: [transfer.to_host(t) for _ in range(per)])
                       for _ in range(n_threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    total = n_threads * per
    assert step.counts == {"host_waits": total, "wait_bytes": 8 * total}


def test_kept_spans_hold_nothing_the_collector_counts(fresh):
    """Closed spans are kept as bytes: a stretch of spans leaves Python's
    young-generation count where it was, so it sets off no collection."""
    import gc

    def stretch(n):
        for _ in range(n):
            with log.span("outer", tiles=2) as outer:
                with log.span("inner"):
                    log.count(host_waits=1)
        return outer

    config.TIMING = True
    gc.collect()
    # after it the interpreter's free lists fill again, and the process's
    # first range is made: one-time objects, counted before the stretch
    stretch(100)
    gc.disable()
    try:
        before = gc.get_count()[0]
        outer = stretch(1000)
        after = gc.get_count()[0]
    finally:
        gc.enable()
    assert abs(after - before) <= 5, (before, after)
    assert outer.counts == {"tiles": 2, "host_waits": 1}
    assert len(log.spans()) == 2200


# --------------------------------------------------------------- readers


READERS = ["render_ms.train", "backward_ms.train", "optimizer_ms.train", "host_waits.train",
           "window_slots_m.train", "render_ms.frame", "host_waits.frame",
           "window_slots_m.frame", "encode_ms.convert", "compress_ms.convert"]


def _fake(name, id_, parent, root, ms=0.0, profiled=True, **counts):
    return types.SimpleNamespace(name=name, id=id_, parent=parent, root=root, start_ns=0,
                                 end_ns=int(ms * 1e6), counts=counts, profiled=profiled)


def _synthetic():
    """Two steps, two frames, a conversion and an export, and spans recorded
    with the profiler off (left out)."""
    return [
        _fake("render", 2, 1, 1, 10.0), _fake("backward", 3, 1, 1, 4.0),
        _fake("optimizer", 4, 1, 1, 1.0), _fake("optimizer", 5, 1, 1, 2.0),
        _fake("train_step", 1, None, 1, 20.0, host_waits=12, window_slots=3_599_296),
        _fake("render", 7, 6, 6, 14.0), _fake("backward", 8, 6, 6, 6.0),
        _fake("train_step", 6, None, 6, 24.0, host_waits=12, window_slots=3_599_296),
        _fake("render", 10, None, 10, 8.0, host_waits=12, window_slots=2_000_000),
        _fake("render", 11, None, 11, 12.0, host_waits=10, window_slots=1_000_000),
        _fake("encode", 13, 12, 12, 30.0), _fake("convert", 12, None, 12, 500.0),
        _fake("encode", 15, 14, 14, 50.0), _fake("compress", 16, 14, 14, 200.0),
        _fake("export", 14, None, 14, 300.0),
        _fake("train_step", 20, None, 20, 99.0, profiled=False, host_waits=99),
        _fake("render", 21, 20, 20, 99.0, profiled=False),
    ]


WANT = {"render_ms.train": 12.0, "backward_ms.train": 5.0, "optimizer_ms.train": 1.5,
        "host_waits.train": 12.0, "window_slots_m.train": 3.599296, "render_ms.frame": 10.0,
        "host_waits.frame": 11.0, "window_slots_m.frame": 1.5, "encode_ms.convert": 40.0,
        "compress_ms.convert": 100.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_without_spans_and_the_mean_of_a_buffer(name, monkeypatch):
    from gsbench import spec

    read = spec.metric_reader(name).read
    monkeypatch.setattr(log, "spans", lambda: [])
    assert read(None) is None
    monkeypatch.setattr(log, "spans", _synthetic)
    assert read(None) == pytest.approx(WANT[name], rel=1e-12)
    # a port without the buffer (an older version): nothing to read
    monkeypatch.delattr(log, "spans")
    assert read(None) is None


# ---------------------------------------------------------------- timing


def test_timing_prints_the_stage_and_sog_lines(tmp_path, capsys, fresh):
    src = str(tmp_path / "scene.ply")
    get_handler("3dgs").write(_scene(n=2048, sh_degree=2), src)
    conv = Converter(src, str(tmp_path / "out.sog"), "sog", device="cpu")
    conv.run(min_opacity=1, timing=True, compression_level=1)
    out = capsys.readouterr().out
    stages = [line.split(":")[0][len("[timing] "):] for line in out.splitlines()
              if line.startswith("[timing] ")]
    sog = [s for s in stages if s.startswith("sog.")]
    assert sog == ["sog." + t for t in (
        "detect_bands", "upload", "morton_order", "shN_quant_u8", "shN_fit_dispatch",
        "encode_threads_join", "texture_imgs", "shN_fit+centroids_pull", "shN_labels_pull",
        "shN_codebook_imgs", "labels+meta", "webp_flush")]
    plain = [s for s in stages if not s.startswith("sog.")]
    assert plain == [name for name, _, _ in conv.timer.records]
    assert plain[0] == "read" and plain[-1] == "write" and "alpha" in plain
    # the same stages as spans: one conversion, the SOG stages under write
    spans = log.spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "convert" and not root.profiled
    (write,) = [s for s in spans if s.name == "write"]
    assert sorted(s.name for s in spans if s.parent == write.id) == sorted(sog)
    # the palette fit, inside its dispatch stage: level 1's 2 chunks of 1024
    # centroids at 2,048 splats, 10 Lloyd steps
    (fit,) = [s for s in spans if s.name == "palette_fit"]
    (dispatch,) = [s for s in spans if s.name == "sog.shN_fit_dispatch"]
    assert fit.parent == dispatch.id
    assert fit.counts == {"chunks": 2, "k_per_chunk": 1024, "lloyd_steps": 10}


@pytest.mark.parametrize("fmt,spans_of", [
    ("splat", ["encode", "file"]), ("spz", ["encode", "compress", "file"]),
    ("compressed_ply", ["encode", "file"]), ("ksplat", ["encode", "file", "encode", "file"])])
def test_writers_split_into_encode_compress_and_file(tmp_path, fresh, fmt, spans_of):
    cloud = _scene(n=600, sh_degree=2).to_device("cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        Converter("", str(tmp_path / f"out.{fmt}"), fmt, device="cpu").write_processed(cloud)
    spans = log.spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "export"
    (write,) = [s for s in spans if s.name == "write"]
    assert [s.name for s in _children(spans, write)] == spans_of


@pytest.mark.parametrize("n", [600, 20_000])
def test_the_spz_compress_span_counts_its_deflate_chunks(tmp_path, fresh, n):
    """A payload above one chunk deflates in ceil(payload / CHUNK) chunks on
    the pool; one chunk or less takes the serial gzip (0 chunks)."""
    from gsconverter_tpu_torch.formats import spz

    config.TIMING = True
    path = str(tmp_path / "out.spz")
    Converter("", path, "spz", device="cpu").write_processed(_scene(n=n),
                                                             compression_level=1)
    with open(path, "rb") as f:
        payload = len(gzip.decompress(f.read()))
    (compress,) = [s for s in log.spans() if s.name == "compress"]
    chunks = -(-payload // spz.CHUNK)
    assert compress.counts["deflate_chunks"] == (chunks if chunks > 1 else 0)
    assert compress.counts["deflate_workers"] >= 1
    assert (n > 10_000) == (chunks > 1)


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_a_frames_host_waits_are_the_device_traces_pageable_copies(tmp_path, fresh):
    """A 1M-splat SH-3 frame at 1088 x 1920 (BASELINE config 4's shape):
    the render's counted waits equal the blocking host-to-device copies the
    device trace shows, and every span lies within ``CLOCK_US`` of its
    range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K5 (csrc/composite.cu) has no CPU mode")
    r = np.random.default_rng(11)
    n = 1_000_000
    host = SplatCloud(pos=r.normal(0, 1, (n, 3)).astype(np.float32),
                      sh_dc=r.normal(0, 0.5, (n, 3)).astype(np.float32),
                      sh_rest=r.normal(0, 0.1, (n, 3, 15)).astype(np.float32),
                      opacity=r.normal(-1, 1, n).astype(np.float32),
                      log_scale=r.normal(-5.5, 0.3, (n, 3)).astype(np.float32),
                      quat=np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
                      normal=np.zeros((n, 3), np.float32), active_sh_degree=3)
    cloud = host.device()
    cam = rz.Camera.look_at((0, 0, 5), (0, 0, 0), fov_deg=60.0, width=1920, height=1088,
                            device="cuda")
    b = rz.auto_budget(cloud, cam, cap=1024, glob_cap=256, band_chunk=128)
    kw = dict(max_global=b["max_global"], tile_chunk=128, block_m=64,
              tile_order=b["tile_order"], band_plan=b["band_plan"])
    with torch.no_grad():
        rz.render(cloud, cam, **kw)  # warm: the kernels built and loaded
    torch.cuda.synchronize()
    log.clear_spans()
    k5 = rz.LAUNCHES["composite_fwd"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            torch.no_grad():
        rz.render(cloud, cam, **kw)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e["name"] and "Pageable" in e["name"]]
    (root,) = [s for s in log.spans() if s.parent is None]
    assert root.name == "render" and root.counts["bands"] == len(kw["band_plan"])
    assert root.counts["host_waits"] == len(copies) == 2 * len(kw["band_plan"])
    # one K5 launch a band
    assert rz.LAUNCHES["composite_fwd"] - k5 == root.counts["bands"]
    assert _worst_clock_us(log.spans(), path) <= CLOCK_US
