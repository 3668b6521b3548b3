"""Multi-process worlds for the tests of ``gsconverter_tpu_torch.parallel``.

``run_world`` spawns one process a rank (``torch.multiprocessing``, gloo
over a ``file://`` rendezvous in the test's temporary directory, one CPU
thread each), runs one of the scenario functions below on every rank with
the inputs the test gave, and returns each rank's results.  The workers
import neither JAX nor the tests' ``conftest.py``: the JAX side of every
comparison runs in the test process.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_world(scenario: str, world: int, tmp_path, inputs: dict) -> list[dict]:
    """Run ``SCENARIOS[scenario](mesh, inputs, workdir)`` on ``world`` ranks;
    returns the ranks' result dicts in rank order."""
    root = os.path.join(str(tmp_path), f"{scenario}_w{world}")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    mp.spawn(_worker, args=(world, root, scenario), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _worker(rank: int, world: int, root: str, scenario: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/pg", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        from gsconverter_tpu_torch.parallel.mesh import make_mesh, set_active_mesh

        mesh = make_mesh(device="cpu")
        set_active_mesh(mesh)
        with open(os.path.join(root, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        work = os.path.join(root, "work")
        os.makedirs(work, exist_ok=True)
        result = SCENARIOS[scenario](mesh, inputs, work)
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def _cloud(leaves: dict):
    from gsconverter_tpu_torch.cloud import SplatCloud

    return SplatCloud(**leaves)


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _single(fn):
    """``fn()`` with the single-device ops (no mesh), then back on the mesh."""
    from gsconverter_tpu_torch.parallel.mesh import active_mesh, set_active_mesh

    mesh = active_mesh()
    set_active_mesh(None)
    try:
        return fn()
    finally:
        set_active_mesh(mesh)


def _fixed_init(inits: np.ndarray):
    """A stand-in for ``ops.kmeans.init_centroids`` that returns given
    inits: [C, k, D] for the chunks from ``chunk_offset`` on, or [k, D]."""
    def init(x, k, seed, valid=None, n_valid=None, chunk_offset=0):
        if x.dim() == 3:
            got = inits[chunk_offset:chunk_offset + x.shape[0]]
        else:
            got = inits
        assert got.shape[-2] == k
        return torch.from_numpy(np.array(got)).to(x.device)
    return init


# ---------------------------------------------------------------- scenarios


def parallel_scenario(mesh, inp, work) -> dict:
    """shard_cloud / place_cloud, sharded SOR, both sharded K-Means and the
    sharded PLY IO, each beside the single-device port where it has one."""
    from gsconverter_tpu_torch.formats import get_handler
    from gsconverter_tpu_torch.ops import kmeans as km
    from gsconverter_tpu_torch.ops import sor
    from gsconverter_tpu_torch.parallel import distributed as pd
    from gsconverter_tpu_torch.parallel.io import (gather_and_write, read_ply_sharded,
                                                   shard_bounds, write_ply_strided)
    from gsconverter_tpu_torch.parallel.sharding import place_cloud, shard_cloud

    res = {}
    cloud = _cloud(inp["cloud"])
    shard, valid_n = shard_cloud(cloud, mesh)
    res["shard"] = {name: a.numpy() for name, a in shard._named_leaves().items()}
    res["shard_valid_n"] = valid_n
    res["place_pos"] = place_cloud(cloud, mesh).pos.numpy()

    for name, pos, k, sigma, _ in inp["sor"]:
        t = torch.from_numpy(pos)
        pd.BYTES["halo"] = 0
        res[f"sor_{name}"] = pd.sharded_sor_mask(t, mesh, k=k, sigma=sigma).numpy()
        res[f"sor_{name}_halo_bytes"] = pd.BYTES["halo"]
        res[f"sor_{name}_single"] = sor.sor_mask(t, k, sigma).numpy()

    for name, x, chunks, k, iters, seed, inits in inp["chunked"]:
        c, lab = km.kmeans_chunked(x, chunks, k, max_iter=iters, seed=seed, device="cpu")
        c1, lab1 = _single(lambda: km.kmeans_chunked(x, chunks, k, max_iter=iters,
                                                     seed=seed, device="cpu"))
        res[f"chunked_{name}"] = (c.numpy(), lab.numpy(), c1.numpy(), lab1.numpy())
        if inits is not None:
            orig = km.init_centroids
            km.init_centroids = _fixed_init(inits)
            try:
                c, lab = km.kmeans_chunked(x, chunks, k, max_iter=iters, seed=seed,
                                           device="cpu")
            finally:
                km.init_centroids = orig
            res[f"chunked_{name}_jax_init"] = (c.numpy(), lab.numpy())

    x, k = inp["kmeans_quality"]
    c, lab = pd.sharded_kmeans(torch.from_numpy(x), k, mesh, max_iter=10)
    res["kmeans_quality"] = (c.numpy(), lab.numpy())
    x, k, iters, seed, init = inp["kmeans_jax_init"]
    orig = km.init_centroids
    calls = []

    def init_fn(pool, k_, seed_, **kw):
        calls.append(tuple(pool.shape))
        return _fixed_init(init)(pool, k_, seed_, **kw)
    km.init_centroids = init_fn
    try:
        c, lab = km.kmeans(x, k, max_iter=iters, seed=seed, device="cpu")
    finally:
        km.init_centroids = orig
    res["kmeans_jax_init"] = (c.numpy(), lab.numpy(), calls)

    # strided PLY write: ranks arrive last to first; then over a longer
    # stale file
    ply_cloud = _cloud(inp["ply_cloud"])
    n = ply_cloud.n
    lo, hi = shard_bounds(n, mesh.rank, mesh.size)
    local = ply_cloud.select(np.arange(lo, hi))
    strided = os.path.join(work, "strided.ply")
    stale = os.path.join(work, "stale.ply")
    if mesh.rank == 0:
        get_handler("3dgs").write(ply_cloud, os.path.join(work, "single.ply"))
        with open(stale, "wb") as f:
            f.write(b"\xab" * (os.path.getsize(os.path.join(work, "single.ply")) + 4099))
    for turn in reversed(range(mesh.size)):
        if turn == mesh.rank:
            write_ply_strided(local, strided, mesh.rank, mesh.size, n)
        mesh.barrier()
    write_ply_strided(local, stale, mesh.rank, mesh.size, n)
    mesh.barrier()
    try:
        write_ply_strided(local.select(np.arange(min(5, local.n - 1))), strided,
                          mesh.rank, mesh.size, n)
        res["strided_mismatch_raised"] = False
    except ValueError:
        res["strided_mismatch_raised"] = True
    res["read_sharded_pos"] = read_ply_sharded(os.path.join(work, "single.ply"),
                                               mesh.rank, mesh.size).pos
    mesh.barrier()
    if mesh.rank == 0:
        res["ply_single"] = _digest(os.path.join(work, "single.ply"))
        res["ply_strided"] = _digest(strided)
        res["ply_stale"] = _digest(stale)
        res["ply_stale_size"] = os.path.getsize(stale)
        res["ply_single_size"] = os.path.getsize(os.path.join(work, "single.ply"))

    # gather_and_write: .ply (strided) from each rank's read shard; .splat
    # (gathered to rank 0) from each rank's GSPMD-split rows
    writes = []
    handler = get_handler("3dgs")

    def spy(writer):
        def w(c, path, **kw):
            writes.append(os.path.basename(path))
            return writer(c, path, **kw)
        return w
    mine = read_ply_sharded(os.path.join(work, "single.ply"), mesh.rank, mesh.size)
    gather_and_write(mine, os.path.join(work, "gathered.ply"), spy(handler.write))
    splat_cloud = _cloud(inp["splat_cloud"])
    gather_and_write(place_cloud(splat_cloud, mesh).to_numpy(),
                     os.path.join(work, "gathered.splat"), spy(get_handler("splat").write))
    res["gather_writes"] = writes
    if mesh.rank == 0:
        get_handler("splat").write(splat_cloud, os.path.join(work, "single.splat"))
        res["gathered_ply"] = _digest(os.path.join(work, "gathered.ply"))
        res["gathered_splat"] = _digest(os.path.join(work, "gathered.splat"))
        res["single_splat"] = _digest(os.path.join(work, "single.splat"))
    mesh.barrier()
    return res


def pipeline_scenario(mesh, inp, work) -> dict:
    """The ops' and the Converter's automatic dispatch under the mesh,
    beside the same calls with no mesh."""
    from gsconverter_tpu_torch import converter as conv_mod
    from gsconverter_tpu_torch.formats import sog as sog_mod
    from gsconverter_tpu_torch.ops import filters, kmeans as km
    from gsconverter_tpu_torch.parallel import distributed as pd

    res = {}
    calls = {"sor": 0, "chunked": 0, "kmeans": 0, "writes": [], "bundles": 0}
    orig_sor, orig_chunked, orig_kmeans = (pd.sharded_sor_mask, pd.sharded_kmeans_chunked,
                                           pd.sharded_kmeans)

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    pd.sharded_sor_mask = counting("sor", orig_sor)
    pd.sharded_kmeans_chunked = counting("chunked", orig_chunked)
    pd.sharded_kmeans = counting("kmeans", orig_kmeans)

    # remove_flyers: mesh dispatch against the single-device filter
    fly = _cloud(inp["flyers"])
    out_m = filters.remove_flyers(fly, intensity=5, device="cpu")
    out_s = _single(lambda: filters.remove_flyers(fly, intensity=5, device="cpu"))
    res["flyers"] = (out_m.pos, out_s.pos, calls["sor"])

    # kmeans_chunked: auto-dispatch to the sharded path (and declined)
    x = inp["chunked_x"]
    c, lab = km.kmeans_chunked(x, 8, 32, max_iter=5, device="cpu")
    c1, lab1 = _single(lambda: km.kmeans_chunked(x, 8, 32, max_iter=5, device="cpu"))
    res["chunked"] = (c.numpy(), lab.numpy(), c1.numpy(), lab1.numpy(), calls["chunked"])
    before = calls["chunked"]
    c, lab = km.kmeans_chunked(x, 3, 32, max_iter=2, device="cpu")
    c1, lab1 = _single(lambda: km.kmeans_chunked(x, 3, 32, max_iter=2, device="cpu"))
    res["chunked_declined"] = (c.numpy(), lab.numpy(), c1.numpy(), lab1.numpy(),
                               calls["chunked"] - before)
    res["dispatch"] = [km._dispatch_mesh(1024, chunks=3) is None,
                       km._dispatch_mesh(1023) is None,
                       km._dispatch_mesh(1024, chunks=mesh.size) is mesh,
                       km._dispatch_mesh(4096) is mesh]

    if not inp.get("converter"):
        return res
    # the Converter: which rank writes, and the files against one process's
    get_handler = conv_mod.get_handler

    def spy_handler(name):
        h = get_handler(name)
        write = h.write

        def w(cloud, path, **kw):
            calls["writes"].append(name)
            return write(cloud, path, **kw)
        h.write = w
        return h

    class Bundle(sog_mod._ImageBundle):
        def __init__(self, *a, **kw):
            calls["bundles"] += 1
            super().__init__(*a, **kw)
    conv_mod.get_handler = spy_handler
    sog_mod._ImageBundle = Bundle
    src = inp["scene"]
    runs = (("splat", "splat", dict(sor_intensity=5, density_sensitivity=0.5)),
            ("sog", "sog", dict(sor_intensity=5, density_sensitivity=0.5,
                                compression_level=9)))
    for label, fmt, flags in runs:
        before = dict(sor=calls["sor"], chunked=calls["chunked"], bundles=calls["bundles"],
                      writes=len(calls["writes"]))
        mesh_out = os.path.join(work, f"mesh.{fmt}")
        conv_mod.Converter(src, mesh_out, fmt, device="cpu").run(**flags)
        res[f"{label}_calls"] = {key: calls[key] - v for key, v in before.items()
                                 if key != "writes"}
        res[f"{label}_calls"]["writes"] = calls["writes"][before["writes"]:]
        if mesh.rank == 0:
            single = os.path.join(work, f"single.{fmt}")
            _single(lambda: conv_mod.Converter(src, single, fmt, device="cpu").run(**flags))
            res[label] = (_digest(mesh_out), _digest(single), mesh_out)
        mesh.barrier()

    # a checkpointed run, then its resume; against one process's file
    ck = os.path.join(work, "ck")
    flags = dict(sor_intensity=5, density_sensitivity=0.5, checkpoint_dir=ck)
    first = os.path.join(work, "ckpt.splat")
    conv_mod.Converter(src, first, "splat", device="cpu").run(**flags)
    mesh.barrier()
    if mesh.rank == 0:
        import json

        with open(os.path.join(ck, "sor", "manifest.json")) as f:
            res["manifest"] = json.load(f)
        res["shard_rows"] = []
        for s in range(mesh.size):
            with np.load(os.path.join(ck, "sor", f"shard{s}.npz")) as z:
                res["shard_rows"].append(int(z["pos"].shape[0]))
        os.unlink(first)
    mesh.barrier()
    before = calls["sor"]
    conv_mod.Converter(src, first, "splat", device="cpu").run(**flags)
    res["resume_sor_calls"] = calls["sor"] - before
    if mesh.rank == 0:
        res["ckpt"] = _digest(first)
    mesh.barrier()
    res.update(_cli_over_existing_output(mesh, src, work))
    return res


def _cli_over_existing_output(mesh, src, work) -> dict:
    """The CLI converting onto an existing file with each answer to its
    overwrite prompt (an EOF: no answer): who prompted, what each rank
    returned and printed, and the file's size after."""
    import builtins
    import contextlib
    import io

    from gsconverter_tpu_torch import main as cli

    out = {}
    path = os.path.join(work, "cli.splat")
    for answer in ("n", "y", "eof"):
        if mesh.rank == 0:
            open(path, "wb").close()
        mesh.barrier()
        prompts = []

        def fake_input(prompt=""):
            prompts.append(prompt)
            if answer == "eof":
                raise EOFError
            return answer
        orig, builtins.input = builtins.input, fake_input
        text = io.StringIO()
        try:
            with contextlib.redirect_stdout(text):
                rc = cli.main(["-i", src, "-o", path, "-f", "splat", "--device", "cpu"])
        finally:
            builtins.input = orig
        mesh.barrier()
        out[f"cli_{answer}"] = dict(rc=rc, prompts=prompts, size=os.path.getsize(path),
                                    source_info=text.getvalue().count(">>> SOURCE FILE INFO"),
                                    target_info=text.getvalue().count(">>> TARGET FILE INFO"))
        mesh.barrier()
    return out


def render_scenario(mesh, inp, work) -> dict:
    """The depth- and tile-sharded renders, the band occupancy, the sharded
    training step beside one device's, and ``dryrun_multichip``."""
    import contextlib
    import io

    from gsconverter_tpu_torch.parallel import distributed as pd
    from gsconverter_tpu_torch.parallel import train as ptrain
    from gsconverter_tpu_torch.render import train as rtrain

    res = {}
    cloud, cam, kw = inp["render"]
    res["render"] = pd.sharded_render(_cloud(cloud), cam, mesh, **kw).numpy()
    for name, (cloud, cam, budget, kw) in inp["tiles"].items():
        pd.BYTES.update(dict.fromkeys(pd.BYTES, 0))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            img = pd.sharded_render_tiles(_cloud(cloud), cam, mesh, budget=budget, **kw)
        res[f"tiles_{name}"] = (img.numpy(), out.getvalue(), dict(pd.BYTES))
    for name, (cloud, cam) in inp["occupancy"].items():
        res[f"occupancy_{name}"] = pd.band_occupancy(_cloud(cloud), cam, mesh).numpy()
    cloud, cam = inp["rows_split"]
    try:
        pd.sharded_render_tiles(_cloud(cloud), cam, mesh)
        res["rows_split"] = None
    except ValueError as e:
        res["rows_split"] = str(e)

    # one sharded step of the tiny scene, and the same step on one device
    cloud, cam = ptrain.tiny_scene(**inp["step"])
    base = cloud.to_device("cpu")
    target = torch.zeros(cam.height, cam.width, 3)
    kw = dict(max_per_tile=64, tile_chunk=2)
    for label, make in (
            ("sharded", lambda o, p: ptrain.make_sharded_train_step(base, cam, o, p, mesh, **kw)),
            ("single", lambda o, p: rtrain.make_train_step(base, cam, o, p, **kw))):
        params = {k: getattr(base, k).clone().requires_grad_(True) for k in rtrain.TRAINABLE}
        opt = torch.optim.Adam(list(params.values()), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
        pd.BYTES.update(dict.fromkeys(pd.BYTES, 0))
        loss = float(make(opt, params)(target))
        res[f"step_{label}"] = dict(
            loss=loss, bytes=dict(pd.BYTES),
            grads={k: v.grad.numpy().copy() for k, v in params.items()},
            params={k: v.detach().numpy().copy() for k, v in params.items()},
            digest=hashlib.sha256(b"".join(v.detach().numpy().tobytes()
                                           for v in params.values())).hexdigest())
    res["dryrun"] = ptrain.dryrun_multichip(mesh)
    return res


SCENARIOS = {"parallel": parallel_scenario, "pipeline": pipeline_scenario,
             "render": render_scenario}


def cloud_leaves(cloud) -> dict:
    """A port host cloud as the keyword arguments of ``SplatCloud``."""
    return dict(pos=cloud.pos, sh_dc=cloud.sh_dc, sh_rest=cloud.sh_rest,
                opacity=cloud.opacity, log_scale=cloud.log_scale, quat=cloud.quat,
                normal=cloud.normal, rgb=cloud.rgb, extras=dict(cloud.extras),
                active_sh_degree=cloud.active_sh_degree)
