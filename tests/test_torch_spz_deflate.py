"""The .spz writer's parallel gzip (``formats/spz.py::_gzip``) on the CPU.

A payload longer than one chunk is one gzip member of raw deflate chunks
made on a thread pool; these tests hold it to ``gzip.compress``: the same
inflated bytes, a size within 0.5%, the same file whatever the pool's size,
and ``gzip.compress``'s own bytes at level 0 and for one chunk or less.  The
multi-chunk file reads to the same cloud in the port's reader, the JAX
package's and the benchmark's plain reference.
"""

import gzip
import os
import sys
import threading

import numpy as np
import pytest

from gsbench.reference.convert import read_spz
from gsconverter_tpu.formats import get_handler as jax_handler
from gsconverter_tpu_torch.formats import get_handler
from gsconverter_tpu_torch.formats import spz
from tests.conftest import make_cloud
from tests.torch_port_helpers import assert_clouds_equal, to_port


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def cloud():
    """A 20k-splat SH-3 host cloud: a payload of about 1.3 MB, 5 chunks."""
    return to_port(make_cloud(20_000, sh_degree=3, seed=4).to_numpy())


@pytest.fixture(scope="module")
def payload(cloud, tmp_path_factory):
    """The writer's payload (header and sections), from a level-0 file."""
    path = str(tmp_path_factory.mktemp("spz") / "stored.spz")
    get_handler("spz").write(cloud, path, compression_level=0)
    data = gzip.decompress(_bytes(path))
    assert len(data) > 4 * spz.CHUNK
    return data


def test_a_multi_chunk_file_inflates_to_the_payload(cloud, payload, tmp_path):
    path = str(tmp_path / "t.spz")
    get_handler("spz").write(cloud, path, compression_level=1)
    assert gzip.decompress(_bytes(path)) == payload


@pytest.mark.parametrize("level", [1, 6])
def test_the_bytes_do_not_depend_on_the_worker_count(payload, level):
    by_workers = {w: spz._gzip(payload, level, workers=w) for w in (1, 2, 3, 8)}
    assert len(set(by_workers.values())) == 1
    assert spz._gzip(payload, level) == by_workers[1]
    assert gzip.decompress(by_workers[3]) == payload


@pytest.mark.parametrize("level", [1, 6, 9])
def test_the_size_is_within_half_a_percent_of_one_deflate(payload, level):
    serial = len(gzip.compress(payload, compresslevel=level, mtime=0))
    assert abs(len(spz._gzip(payload, level)) - serial) <= serial * 0.005


@pytest.mark.parametrize("level", [1, 6, 9])
def test_a_one_chunk_payload_is_gzip_compress_byte_for_byte(payload, level):
    data = payload[:spz.CHUNK // 2]
    assert spz._gzip(data, level) == gzip.compress(data, compresslevel=level, mtime=0)


@pytest.mark.parametrize("extra", [0, 1])
def test_a_chunk_and_a_chunk_plus_one_byte_round_trip(payload, extra):
    data = payload[:spz.CHUNK + extra]
    out = spz._gzip(data, 1, workers=2)
    assert gzip.decompress(out) == data
    assert (out == gzip.compress(data, compresslevel=1, mtime=0)) == (extra == 0)


def test_level_zero_takes_the_serial_path(payload, monkeypatch):
    calls = []
    serial = gzip.compress

    def spy(data, compresslevel, mtime):
        calls.append((len(data), compresslevel))
        return serial(data, compresslevel=compresslevel, mtime=mtime)

    def no_pool(workers):
        raise AssertionError("the pool ran at level 0")

    monkeypatch.setattr(spz.gzip, "compress", spy)
    monkeypatch.setattr(spz, "_pool", no_pool)
    assert spz._gzip(payload, 0) == serial(payload, compresslevel=0, mtime=0)
    assert calls == [(len(payload), 0)]


def test_the_pool_is_remade_in_a_new_process(payload, monkeypatch):
    spz._gzip(payload, 1, workers=2)
    first = spz._POOL
    assert spz._gzip(payload, 1, workers=2) and spz._POOL is first
    pid = os.getpid()
    monkeypatch.setattr(spz.os, "getpid", lambda: pid + 1)
    assert gzip.decompress(spz._gzip(payload, 1, workers=2)) == payload
    assert spz._POOL is not first


def test_writers_on_many_threads_share_the_pool(payload):
    """Writers asking for pools of other sizes at once (each a remake)
    all finish, each with the one file."""
    want = spz._gzip(payload, 1)
    data = payload[:3 * spz.CHUNK + 5]
    small = spz._gzip(data, 1)
    got = {}

    def write(i):
        d = payload if i % 4 == 0 else data
        got[i] = spz._gzip(d, 1, workers=1 + i % 5) == (want if i % 4 == 0 else small)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=write, args=(i,)) for i in range(3 * os.cpu_count())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got == {i: True for i in range(len(threads))}


def test_a_multi_chunk_file_reads_alike_in_every_reader(cloud, tmp_path, monkeypatch):
    """The host and the device cloud write the same file, which the port's,
    the JAX package's and the reference's readers read as they read the
    file one serial gzip writes."""
    h = get_handler("spz")
    host, dev, serial = (str(tmp_path / f"{x}.spz") for x in ("host", "dev", "serial"))
    h.write(cloud, host, compression_level=1)
    h.write(cloud.device("cpu"), dev, device="cpu", compression_level=1)
    assert _bytes(host) == _bytes(dev)
    with monkeypatch.context() as m:
        m.setattr(spz, "_gzip", lambda data, level: gzip.compress(
            data, compresslevel=level, mtime=0))
        h.write(cloud, serial, compression_level=1)
    assert _bytes(host) != _bytes(serial)
    assert gzip.decompress(_bytes(host)) == gzip.decompress(_bytes(serial))

    ours = h.read(host)
    assert ours.n == cloud.n and ours.active_sh_degree == 3
    assert_clouds_equal(ours, h.read(serial))
    assert_clouds_equal(ours, jax_handler("spz").read(host))
    assert_clouds_equal(jax_handler("spz").read(host), jax_handler("spz").read(serial))
    ref, ref_serial = read_spz(host), read_spz(serial)
    assert sorted(ref) == sorted(ref_serial)
    for k, v in ref.items():
        np.testing.assert_array_equal(v, ref_serial[k], k)
