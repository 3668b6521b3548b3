"""Parquet columnar codec.

Column contract (reference formats/parquet.py): ``x,y,z[,nx,ny,nz]``,
``cov_q0..3`` (quaternion with rot_0 (w) stored as cov_q3 — x,y,z,w order),
``cov_s0..2`` (log scales), ``alpha`` (logit opacity), then SH channel-major
``r_sh0..15, g_sh0..15, b_sh0..15`` where ``*_sh0`` is the DC coefficient —
strict column order (parquet.py:79-91); extras follow.

pandas is imported inside ``read`` and ``write`` only: nothing else of the
package needs it.
"""

from __future__ import annotations

import numpy as np

from ..cloud import SplatCloud, covering_degree_for_dim
from ..utils.log import debug_print, status_print
from .base import BaseFormat, register


@register
class ParquetFormat(BaseFormat):
    name = "parquet"
    extension = ".parquet"
    max_sh_degree = 3

    def read(self, path: str, **kwargs) -> SplatCloud:
        import pandas as pd

        debug_print(f"[DEBUG] Reading Parquet file from {path}")
        df = pd.read_parquet(path)
        n = len(df)

        def col(name, default=0.0):
            if name in df.columns:
                return np.asarray(df[name].values, dtype=np.float32)
            return np.full(n, default, np.float32)

        pos = np.stack([col("x"), col("y"), col("z")], axis=1)
        normal = np.stack([col("nx"), col("ny"), col("nz")], axis=1)
        quat = np.stack([col("cov_q3", 1.0), col("cov_q0"), col("cov_q1"), col("cov_q2")],
                        axis=1)
        log_scale = np.stack([col("cov_s0"), col("cov_s1"), col("cov_s2")], axis=1)
        sh_dc = np.stack([col("r_sh0"), col("g_sh0"), col("b_sh0")], axis=1)
        opacity = col("alpha")

        sh_rest = np.zeros((n, 3, 15), np.float32)
        max_dim = 0
        for c, ch in enumerate("rgb"):
            for j in range(1, 16):
                name = f"{ch}_sh{j}"
                if name in df.columns:
                    sh_rest[:, c, j - 1] = df[name].values
                    max_dim = max(max_dim, j)

        rgb = None
        if "red" in df.columns:
            rgb = np.stack([df["red"], df["green"], df["blue"]], axis=1).astype(np.uint8)

        return SplatCloud(
            pos=pos, sh_dc=sh_dc, sh_rest=sh_rest, opacity=opacity,
            log_scale=log_scale, quat=quat, normal=normal, rgb=rgb,
            # covering degree of the highest filled coeff index (rounds up)
            active_sh_degree=covering_degree_for_dim(max_dim),
        )

    def write(self, cloud: SplatCloud, path: str, **kwargs) -> None:
        import pandas as pd

        c = cloud.to_numpy()
        cols: dict[str, np.ndarray] = {}
        cols["x"], cols["y"], cols["z"] = c.pos.T
        cols["nx"], cols["ny"], cols["nz"] = c.normal.T
        # (w,x,y,z) -> cov_q(x,y,z,w) (reference parquet.py:65)
        cols["cov_q0"], cols["cov_q1"], cols["cov_q2"] = c.quat[:, 1], c.quat[:, 2], c.quat[:, 3]
        cols["cov_q3"] = c.quat[:, 0]
        for i in range(3):
            cols[f"cov_s{i}"] = c.log_scale[:, i]
        cols["alpha"] = c.opacity
        for ci, ch in enumerate("rgb"):
            cols[f"{ch}_sh0"] = c.sh_dc[:, ci]
            for j in range(15):
                cols[f"{ch}_sh{j + 1}"] = c.sh_rest[:, ci, j]
        order = ["x", "y", "z", "nx", "ny", "nz",
                 "cov_q0", "cov_q1", "cov_q2", "cov_q3",
                 "cov_s0", "cov_s1", "cov_s2", "alpha"]
        for ch in "rgb":
            order += [f"{ch}_sh{j}" for j in range(16)]
        df = pd.DataFrame({k: cols[k] for k in order})
        for name, arr in c.extras.items():
            df[name] = arr
        df.to_parquet(path)
        status_print(f"Parquet write completed. {c.n} rows.")
