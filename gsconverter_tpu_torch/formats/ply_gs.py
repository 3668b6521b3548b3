"""3DGS and CloudCompare PLY codecs.

Behavior parity targets:
  - ``Ply3DGSFormat`` — reference formats/ply_3dgs.py: prefix normalization
    (``scalar_``, ``scal_``, ``scalar_scal_``), zero-padding SH to 45 unless
    ``crop_sh``, extra vertex-prop and extra-element passthrough.
  - ``PlyCCFormat`` — reference formats/ply_cc.py: identical schema but writes
    a ``scalar_`` prefix on all non-spatial props (spatial x..z/n*/rgb stay
    unprefixed, ply_cc.py:86-91) and forces RGB.

The structured-array container is parsed once into a host-resident SoA
cloud (numpy leaves) via grouped strided views — one pass per consecutive
field run instead of one per column.  SH columns of lower-degree files are
re-strided into the canonical [3,15] channel-major layout (a documented
divergence from the reference, which pads 9/24-coeff files verbatim).
"""

from __future__ import annotations

import numpy as np

from ..cloud import MAX_SH_DIM, SplatCloud, covering_degree_for_dim
from ..utils import ply
from ..utils.log import debug_print, status_print
from .base import BaseFormat, register

# Canonical field order of a 3DGS vertex element (reference structures.py:10-17).
_SPATIAL = ("x", "y", "z", "nx", "ny", "nz")
_CORE_TAIL = ("opacity", "scale_0", "scale_1", "scale_2",
              "rot_0", "rot_1", "rot_2", "rot_3")
_RGB = ("red", "green", "blue")


def standard_names(has_rgb: bool, n_rest: int = 45) -> list[str]:
    names = list(_SPATIAL)
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(n_rest)]
    names += list(_CORE_TAIL)
    if has_rgb:
        names += list(_RGB)
    return names


def _detect_prefix(source_names: set[str]) -> str:
    """Prefix sniffing with correct nesting (reference ply_3dgs.py:23-28;
    note ply_cc.py:23-26 has an unreachable elif — we use the correct order)."""
    if "scalar_scal_f_dc_0" in source_names:
        return "scalar_scal_"
    if "scalar_f_dc_0" in source_names:
        return "scalar_"
    if "scal_f_dc_0" in source_names:
        return "scal_"
    return ""


def _get(vertices: np.ndarray, prefix: str, name: str):
    names = vertices.dtype.names
    if name in names:
        return vertices[name]
    if prefix + name in names:
        return vertices[prefix + name]
    if "scalar_" + name in names:
        return vertices["scalar_" + name]
    return None


def _field_view(vertices: np.ndarray, prefix: str, names: list[str]):
    """Zero-copy [n, len(names)] f32 strided VIEW over the record array.

    Requires the resolved fields to be consecutive same-dtype f4 record
    slots (true for every file the reference writes).  Returns None when
    the layout doesn't qualify — callers fall back to copies.  The view is
    read-only when the base is (e.g. an mmap-backed read, utils/ply.read).
    """
    flds = vertices.dtype.fields
    offs = []
    for nm in names:
        for cand in (nm, prefix + nm, "scalar_" + nm):
            if cand in flds and flds[cand][0] == np.dtype("<f4"):
                offs.append(flds[cand][1])
                break
        else:
            return None
    if any(offs[i] != offs[0] + 4 * i for i in range(len(offs))):
        return None
    if len(vertices) == 0:
        return np.zeros((0, len(names)), np.float32)
    return np.ndarray(
        (len(vertices), len(names)), "<f4", buffer=vertices,
        offset=offs[0], strides=(vertices.dtype.itemsize, 4),
    )


def _field_group(vertices: np.ndarray, prefix: str, names: list[str]):
    """[n, len(names)] f32 matrix extracted as ONE strided copy.

    A 1M-splat deg-3 PLY has 62 columns; per-column extraction costs ~62
    cache-line passes over the 248 MB body, group extraction ~8.
    """
    view = _field_view(vertices, prefix, names)
    return None if view is None else np.ascontiguousarray(view)


def cloud_from_vertex_array(
    vertices: np.ndarray, extra_elements: tuple = ()
) -> SplatCloud:
    """Build the canonical SoA cloud from a PLY-style structured vertex array.

    Host-resident result (numpy leaves): the conversion pipeline keeps heavy
    attributes on host and uploads only what device ops consume
    (utils/transfer.py rationale).
    """
    n = len(vertices)
    prefix = _detect_prefix(set(vertices.dtype.names))
    if not vertices.flags.c_contiguous:
        # np.ndarray(buffer=...) group views need a contiguous base
        vertices = np.ascontiguousarray(vertices)

    def col(name, default=0.0):
        v = _get(vertices, prefix, name)
        if v is None:
            return np.full(n, default, np.float32)
        return np.ascontiguousarray(v, dtype=np.float32)

    def group(names, defaults=None, copy=True):
        """Strided f4 run -> matrix.  ``copy=False`` returns a zero-copy
        VIEW over the record buffer (mmap-backed for utils/ply.read files):
        cold leaves that downstream stages touch at most once (normals,
        SH, scales, quats) skip their extraction pass entirely — the page
        cache is read by whichever pass first consumes them.  Hot leaves
        (pos, opacity: many elementwise filter passes each) stay contiguous
        copies, since a [N,k]-of-[N,62] strided view drags the full 248-byte
        record through cache per 12 used bytes on EVERY pass."""
        g = (_field_group if copy else _field_view)(vertices, prefix, names)
        if g is not None:
            return g
        if defaults is None:
            defaults = [0.0] * len(names)
        return np.stack(
            [col(nm, d) for nm, d in zip(names, defaults)], axis=1
        )

    pos = group(["x", "y", "z"])
    normal = group(["nx", "ny", "nz"], copy=False)
    sh_dc = group(["f_dc_0", "f_dc_1", "f_dc_2"], copy=False)

    # SH AC: count present columns; full-width files re-stride to [3,15]
    # as a zero-copy view (last-axis split keeps strides valid), lower
    # degrees need the zero-padded copy.
    n_rest = 0
    for i in range(45):
        if _get(vertices, prefix, f"f_rest_{i}") is None:
            break
        n_rest = i + 1
    if n_rest == 45:
        flat = group([f"f_rest_{i}" for i in range(45)], copy=False)
        # last-axis split of the [N,45] strided view stays a view;
        # reshape silently copies only if the layout can't express it
        sh_rest = flat.reshape(n, 3, 15)
    else:
        sh_rest = np.zeros((n, 3, 15), np.float32)
        dim = n_rest // 3
        if dim:
            # non-multiple-of-3 counts: the trailing 1-2 columns cannot
            # form a complete per-channel coefficient; drop them
            flat = group([f"f_rest_{i}" for i in range(3 * dim)])
            sh_rest[:, :, :dim] = flat.reshape(n, 3, dim)

    opacity = col("opacity")
    log_scale = group(["scale_0", "scale_1", "scale_2"], copy=False)
    quat = group(["rot_0", "rot_1", "rot_2", "rot_3"],
                 defaults=[1.0, 0.0, 0.0, 0.0], copy=False)

    has_rgb = "red" in vertices.dtype.names
    rgb = (
        np.stack([vertices["red"], vertices["green"], vertices["blue"]], axis=1).astype(np.uint8)
        if has_rgb
        else None
    )

    # Extra vertex props: anything not mapped above (reference ply_3dgs.py:30-41).
    std = set()
    for name in standard_names(True):
        std.add(name)
        std.add(prefix + name)
        std.add("scalar_" + name)
    extras = {}
    for name in vertices.dtype.names:
        if name not in std:
            internal = name[7:] if name.startswith("scalar_") else name
            extras[internal] = np.ascontiguousarray(vertices[name])

    return SplatCloud(
        pos=pos,
        sh_dc=sh_dc,
        sh_rest=sh_rest,
        opacity=opacity,
        log_scale=log_scale,
        quat=quat,
        normal=normal,
        rgb=rgb,
        extras=extras,
        # COVERING degree (rounds UP): a non-standard f_rest count (e.g. 30
        # columns -> coeffs 8-9 of band 3 populated) must not be tagged with
        # a floor degree, or detect_active_degree's structural-bound fast
        # path skips the populated band and degree-sized writers drop it
        active_sh_degree=covering_degree_for_dim(n_rest // 3),
        extra_elements=extra_elements,
    )


def vertex_array_from_cloud(
    cloud: SplatCloud, crop_sh: bool, prefix_nonspatial: bool
) -> np.ndarray:
    """Flatten the SoA cloud back into a PLY-ordered structured array."""
    c = cloud.to_numpy()
    n = c.pos.shape[0]
    n_rest = 45
    if crop_sh:
        # Keep only columns up to the last non-zero flat index
        # (reference ply_3dgs.py:69-78).
        flat = c.sh_rest.reshape(n, 3 * MAX_SH_DIM)
        nz = np.nonzero(np.any(flat != 0, axis=0))[0]
        n_rest = int(nz[-1]) + 1 if nz.size else 0

    spatial = set(_SPATIAL) | set(_RGB)

    def out_name(name: str) -> str:
        if prefix_nonspatial and name not in spatial:
            return "scalar_" + name
        return name

    fields: list[tuple[str, str]] = []
    for name in standard_names(c.rgb is not None, n_rest):
        dt = "u1" if name in _RGB else "f4"
        fields.append((out_name(name), dt))
    for name, arr in c.extras.items():
        fields.append((out_name(name), arr.dtype.str))

    out = np.zeros(n, dtype=np.dtype(fields))

    # The f4 core fields occupy two consecutive runs of the record
    # ([x..nz] and [f_dc_0 .. rot_3]); write each run through ONE strided
    # group view instead of 62 per-column scatters (each column scatter is
    # a full cache-line pass over the record array).
    def gview(first: str, width: int):
        if n == 0:
            return np.zeros((0, width), np.float32)
        off = out.dtype.fields[first][1]
        return np.ndarray((n, width), "<f4", buffer=out, offset=off,
                          strides=(out.dtype.itemsize, 4))

    v_sp = gview("x", 6)
    v_sp[:, 0:3] = c.pos
    v_sp[:, 3:6] = c.normal
    v_core = gview(out_name("f_dc_0"), 11 + n_rest)
    v_core[:, 0:3] = c.sh_dc
    flat = c.sh_rest.reshape(n, 3 * MAX_SH_DIM)
    v_core[:, 3:3 + n_rest] = flat[:, :n_rest]
    v_core[:, 3 + n_rest] = c.opacity
    v_core[:, 4 + n_rest:7 + n_rest] = c.log_scale
    v_core[:, 7 + n_rest:11 + n_rest] = c.quat
    if c.rgb is not None:
        for i, name in enumerate(_RGB):
            out[name] = c.rgb[:, i]
    for name, arr in c.extras.items():
        out[out_name(name)] = arr
    return out


class _PlyBase(BaseFormat):
    extension = ".ply"
    max_sh_degree = 3
    supports_extra_elements = True
    _prefix_nonspatial = False

    def read(self, path: str, **kwargs) -> SplatCloud:
        debug_print(f"[DEBUG] Reading PLY ({self.name}) from {path}")
        plyf = ply.read(path)
        if "vertex" not in plyf:
            raise ValueError("PLY file does not contain 'vertex' element")
        extra_elements = tuple(e for e in plyf.elements if e.name != "vertex")
        self.extra_elements = extra_elements
        return cloud_from_vertex_array(plyf["vertex"].data, extra_elements)

    def write(self, cloud: SplatCloud, path: str, **kwargs) -> None:
        debug_print(f"[DEBUG] Writing PLY ({self.name}) to {path}")
        arr = vertex_array_from_cloud(
            cloud, crop_sh=bool(kwargs.get("crop_sh")), prefix_nonspatial=self._prefix_nonspatial
        )
        elements = [ply.PlyElement("vertex", arr)]
        extra = kwargs.get("extra_elements") or ()
        if extra:
            elements.extend(extra)
            status_print(f"Maintained {len(extra)} extra PLY elements.")
        ply.write(path, elements)
        status_print(f"{self.name} PLY write completed. {len(arr)} points.")


@register
class Ply3DGSFormat(_PlyBase):
    name = "3dgs"


@register
class PlyCCFormat(_PlyBase):
    name = "cc"
    needs_rgb = True
    _prefix_nonspatial = True
