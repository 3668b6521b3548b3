"""Config 4's render kernels and times of several source trees, in turns
on one CUDA card.

    python3 tools/render_compare.py TREE [TREE ...]

Each tree is a checkout of the repo (for example the parent commit,
unpacked with ``git archive`` into a git-ignored directory); with one tree
given, the other is the current directory.  The trees run in order and
then in reverse (parent, change, change, parent for two), each in a
process of its own whose ``gsconverter_tpu_torch`` is the tree's (its
``csrc/`` built at first use into that tree's ``build/``).  Every run uses
this checkout's ``chip_smoke.py`` as its harness, so only the package
differs between runs: it mints ``render_bench_scene`` (1M splats, seed 0),
renders it at 1088 x 1920 with the bench's settings (``bench_render``)
and takes the gradient of sum(img^2) with respect to opacity, then
reports, by CUDA events: K5 and K6 per band (also their device time,
``queued_ms``) with their plain versions and bounds (``time_bands``),
the forward and forward + gradient (median of 5), an Adam step
(``bench_train_step``; host clock, synchronised, median of 5), and
ptxas's lines for composite_fwd_kernel and composite_bwd_kernel.  One
JSON line a run; a summary last.  Needs one card; exits 1 without one.
"""

import json
import os
import subprocess
import sys

HARNESS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "chip_smoke.py")

RUN = r'''
import importlib.util, json, sys, time
import numpy as np
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from gsconverter_tpu_torch.render import rasterizer as rz, train
from gsconverter_tpu_torch.utils import cuda_build

torch.backends.cuda.matmul.allow_tf32 = False
cuda_build.build("composite")
cloud = cs.render_bench_scene(cs.RENDER_N).to_device("cuda")
cam, budget, kw = cs.bench_render(rz, cloud)
op = cloud.opacity.clone().requires_grad_(True)
with cs.composite_spy(rz) as spy:
    img = rz.render(cloud.replace(opacity=op), cam, **kw)
    torch.sum(img * img).backward()
    torch.cuda.synchronize()
img = img.detach()

def grad():
    op.grad = None
    im = rz.render(cloud.replace(opacity=op), cam, **kw)
    torch.sum(im * im).backward()

def fwd():
    with torch.no_grad():
        return rz.render(cloud, cam, **kw)

with torch.no_grad():
    bands = cs.time_bands(rz, spy.fwd, spy.bwd)
out = dict(tree=sys.argv[1], bands=bands,
           **{f"{k}_ms": sum(b[f"{k}_ms"] for b in bands) for k in ("k5", "k6")},
           **{f"{k}_device_ms": sum(b[f"{k}_device_ms"] for b in bands) for k in ("k5", "k6")},
           **{f"{k}_bound_ms": sum(b[f"{k}_bound_ms"] for b in bands) for k in ("k5", "k6")},
           fwd_ms=cs.cuda_median_ms(fwd), fwd_grad_ms=cs.cuda_median_ms(grad),
           ptxas={k: cs.ptxas_lines(cuda_build.BUILD_LOG.get("composite", ""), k)
                  for k in ("composite_fwd_kernel", "composite_bwd_kernel")})
step = cs.bench_train_step(train, cloud, cam, kw)
step(img)
times = []
for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(img)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
out["step_ms"] = float(np.median(times))
print("RENDER_COMPARE " + json.dumps(out), flush=True)
'''


def run(tree):
    res = subprocess.run([sys.executable, "-c", RUN, tree, HARNESS], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    sys.stderr.write(res.stderr[-4000:])
    if res.returncode != 0:
        raise SystemExit(f"render_compare: the run in {tree} failed ({res.returncode}):\n"
                         f"{res.stdout[-4000:]}")
    line = next(x for x in res.stdout.splitlines() if x.startswith("RENDER_COMPARE "))
    print(line, flush=True)
    return json.loads(line[len("RENDER_COMPARE "):])


def main():
    import torch

    if not torch.cuda.is_available():
        print("render_compare: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    if len(trees) == 1:
        trees.append(os.path.abspath("."))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    runs = [run(tree) for tree in trees + trees[::-1]]
    summary = {"card": smi}
    for tree in trees:
        mine = [r for r in runs if r["tree"] == tree]
        summary[tree] = {k: [r[k] for r in mine]
                         for k in ("k5_ms", "k5_device_ms", "k6_ms", "k6_device_ms",
                                   "k5_bound_ms", "k6_bound_ms", "fwd_ms", "fwd_grad_ms",
                                   "step_ms")}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
