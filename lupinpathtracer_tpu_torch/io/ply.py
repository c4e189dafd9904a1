"""Binary PLY mesh loader (numpy strided extraction).

A copy of lupinpathtracer_tpu/io/ply.py (the port imports nothing of the
JAX package), which rebuilds the reference's hand-rolled PLY reader
(lupin_loader/src/loader.rs:1274-1566). Same conventions:

- binary_little_endian 1.0 only; float vertex properties x/y/z, nx/ny/nz,
  u|s / v|t, red/green/blue/alpha.
- V coordinate flipped (loader.rs:1434: texture convention is +v down).
- Face lists fan-triangulated (loader.rs:1537-1566).
- Index bounds validated (loader.rs:1453-1458).

Instead of per-vertex strided byte pulls, the whole vertex block is viewed
as one numpy record buffer and sliced per property — the idiomatic host-side
equivalent.
"""

from __future__ import annotations

import numpy as np

from ..scene.scene import MeshCPU


class PlyError(ValueError):
    pass


_PROP_SIZES = {
    "float": 4,
    "float32": 4,
    "int": 4,
    "uint": 4,
    "int32": 4,
    "uint32": 4,
    "short": 2,
    "ushort": 2,
    "uchar": 1,
    "char": 1,
    "double": 8,
}


def load_mesh_ply(path) -> MeshCPU:
    with open(path, "rb") as f:
        data = f.read()

    end = data.find(b"end_header")
    if end < 0:
        raise PlyError(f"{path}: missing end_header")
    nl = data.find(b"\n", end)
    header = data[:nl].decode("ascii", "replace").splitlines()
    body = data[nl + 1 :]

    if not header or header[0].strip() != "ply":
        raise PlyError(f"{path}: not a PLY file")

    num_verts = 0
    num_faces = 0
    vert_props: list[tuple[str, str]] = []  # (type, name)
    face_index_type = None
    cur_element = None
    for line in header[1:]:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            if parts[1] != "binary_little_endian":
                raise PlyError(f"{path}: only binary_little_endian supported")
        elif parts[0] == "comment":
            continue
        elif parts[0] == "element":
            cur_element = parts[1]
            if parts[1] == "vertex":
                num_verts = int(parts[2])
            elif parts[1] == "face":
                num_faces = int(parts[2])
        elif parts[0] == "property":
            if cur_element == "vertex":
                vert_props.append((parts[1], parts[2]))
            elif cur_element == "face":
                if parts[1] != "list" or parts[2] != "uchar":
                    raise PlyError(f"{path}: unsupported face list header")
                if parts[3] not in ("int", "uint", "int32", "uint32"):
                    raise PlyError(f"{path}: unsupported face index type")
                face_index_type = parts[3]

    offsets: dict[str, int] = {}
    offset = 0
    for ptype, pname in vert_props:
        size = _PROP_SIZES.get(ptype)
        if size is None:
            raise PlyError(f"{path}: unknown property type {ptype}")
        if ptype in ("float", "float32"):
            offsets[pname] = offset
        offset += size
    stride = offset

    vert_bytes = num_verts * stride
    if len(body) < vert_bytes:
        raise PlyError(f"{path}: truncated vertex data")
    vblock = np.frombuffer(body[:vert_bytes], np.uint8).reshape(num_verts, stride)

    def col(name: str) -> np.ndarray:
        off = offsets[name]
        return vblock[:, off : off + 4].copy().view("<f4").reshape(num_verts)

    def stack(names) -> np.ndarray:
        return np.stack([col(n) for n in names], axis=1).astype(np.float32)

    if not all(n in offsets for n in ("x", "y", "z")):
        raise PlyError(f"{path}: missing positions")
    positions = stack(("x", "y", "z"))

    normals = None
    if any(n in offsets for n in ("nx", "ny", "nz")):
        if not all(n in offsets for n in ("nx", "ny", "nz")):
            raise PlyError(f"{path}: partial normals")
        normals = stack(("nx", "ny", "nz"))

    u_name = "u" if "u" in offsets else ("s" if "s" in offsets else None)
    v_name = "v" if "v" in offsets else ("t" if "t" in offsets else None)
    texcoords = None
    if u_name or v_name:
        if not (u_name and v_name):
            raise PlyError(f"{path}: partial texcoords")
        texcoords = np.stack([col(u_name), 1.0 - col(v_name)], axis=1).astype(
            np.float32
        )  # V flip, loader.rs:1434

    colors = None
    if any(n in offsets for n in ("red", "green", "blue", "alpha")):
        if not all(n in offsets for n in ("red", "green", "blue")):
            raise PlyError(f"{path}: partial colors")
        a = col("alpha") if "alpha" in offsets else np.ones(num_verts, np.float32)
        colors = np.stack([col("red"), col("green"), col("blue"), a], axis=1).astype(
            np.float32
        )

    # Faces: uchar count + that many (u)int32 indices, fan-triangulated.
    fblock = np.frombuffer(body[vert_bytes:], np.uint8)
    indices = _extract_faces(fblock, num_faces)
    if indices.size and int(indices.max()) >= num_verts:
        raise PlyError(f"{path}: face index out of range")

    return MeshCPU(
        positions=positions,
        indices=indices.reshape(-1, 3),
        normals=normals,
        texcoords=texcoords,
        colors=colors,
    )


def _extract_faces(buf: np.ndarray, num_faces: int) -> np.ndarray:
    """Fan triangulation (loader.rs:1537-1566). Fast path for uniform-arity
    faces (the common case), byte-walk fallback otherwise."""

    if num_faces == 0:
        return np.zeros((0,), np.uint32)
    arity = int(buf[0])
    rec = 1 + 4 * arity
    if buf.size >= num_faces * rec:
        cand = buf[: num_faces * rec].reshape(num_faces, rec)
        if np.all(cand[:, 0] == arity):
            idx = cand[:, 1:].copy().view("<u4").reshape(num_faces, arity)
            fans = [idx[:, [0, 1, 2]]] + [
                idx[:, [0, 2 + j, 3 + j]] for j in range(arity - 3)
            ]
            # (F, tris_per_face, 3) keeps the reference's per-face emission order.
            return np.stack(fans, axis=1).reshape(-1).astype(np.uint32)

    out = []
    pos = 0
    for _ in range(num_faces):
        n = int(buf[pos])
        pos += 1
        face = buf[pos : pos + 4 * n].copy().view("<u4")
        pos += 4 * n
        out.append(face[[0, 1, 2]])
        for j in range(n - 3):
            out.append(face[[0, 2 + j, 3 + j]])
    return np.concatenate(out).astype(np.uint32)
