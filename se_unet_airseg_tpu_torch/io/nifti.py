"""Self-contained NIfTI-1 (.nii / .nii.gz) codec.

The reference delegates volume I/O to SimpleITK and nibabel (reference
util.py:11-22, preprocessing.py:12-24, save_gradients.py:141-142);
neither ships in this environment, and the hot path only ever needs
plain dense volumes with origin/spacing metadata. This codec speaks
the single-file NIfTI-1 dialect those libraries emit:

  * 348-byte header + 4-byte extension flag, data at `vox_offset`;
  * gzip container detected by magic bytes;
  * dtypes uint8/int8/int16/uint16/int32/uint16/float32/float64;
  * `scl_slope`/`scl_inter` applied on read when meaningful;
  * arrays in (z, y, x) index order — SimpleITK's GetArrayFromImage
    convention, which all reference shapes/boxes assume;
  * origin/spacing in (x, y, z), with the RAS<->LPS sign flip ITK
    applies to the sform (so round-trips through SimpleITK agree).

Writing produces an sform-only header (qform_code=0, sform_code=1)
with optional axis-aligned direction.
"""

from __future__ import annotations

import dataclasses
import gzip
import struct

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class NiftiVolume:
    """A dense volume with the metadata the pipeline tracks."""

    array: np.ndarray  # (z, y, x)
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0)  # (x, y, z)
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0)  # (x, y, z), LPS
    direction: np.ndarray | None = None  # 3x3, LPS, column-major axes


def _open_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            return gzip.GzipFile(fileobj=f).read()
        return f.read()


def read_nifti(path: str) -> NiftiVolume:
    raw = _open_bytes(path)
    if len(raw) < 352:
        raise ValueError(f"{path}: truncated NIfTI file")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr == 348:
        en = "<"
    elif struct.unpack_from(">i", raw, 0)[0] == 348:
        en = ">"
    else:
        raise ValueError(f"{path}: not a NIfTI-1 file")
    magic = raw[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(en + "8h", raw, 40)
    ndim = dim[0]
    shape_xyz = tuple(max(1, d) for d in dim[1 : 1 + max(ndim, 3)])
    datatype = struct.unpack_from(en + "h", raw, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(en)
    pixdim = struct.unpack_from(en + "8f", raw, 76)
    vox_offset = int(struct.unpack_from(en + "f", raw, 108)[0]) or 352
    scl_slope, scl_inter = struct.unpack_from(en + "2f", raw, 112)
    sform_code = struct.unpack_from(en + "h", raw, 254)[0]
    srow = np.array(struct.unpack_from(en + "12f", raw, 280), np.float64).reshape(3, 4)

    count = int(np.prod(shape_xyz))
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=vox_offset)
    # NIfTI stores x fastest; C-order reshape of reversed dims gives (..., z, y, x)
    arr = data.reshape(shape_xyz[::-1])
    while arr.ndim > 3 and arr.shape[0] == 1:
        arr = arr[0]
    if scl_slope not in (0.0, 1.0) or (scl_slope != 0.0 and scl_inter != 0.0):
        arr = arr * scl_slope + scl_inter
    arr = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder("=")))

    if sform_code > 0:
        rot = srow[:, :3]
        # ITK converts NIfTI RAS to LPS: negate rows 0 and 1
        lps = rot * np.array([[-1.0], [-1.0], [1.0]])
        spacing = tuple(np.linalg.norm(rot[:, i]) for i in range(3))
        spacing = tuple(s if s > 0 else p for s, p in zip(spacing, pixdim[1:4]))
        origin = (-srow[0, 3], -srow[1, 3], srow[2, 3])
        with np.errstate(invalid="ignore"):
            direction = lps / np.maximum(np.asarray(spacing)[None, :], 1e-12)
    else:
        spacing = tuple(abs(p) or 1.0 for p in pixdim[1:4])
        origin = (0.0, 0.0, 0.0)
        direction = np.eye(3)
    return NiftiVolume(arr, tuple(map(float, spacing)), tuple(map(float, origin)), direction)


def nifti_shape(path: str) -> tuple[int, ...]:
    """The shape of `read_nifti(path).array`, from the header alone."""
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        raw = gzip.GzipFile(fileobj=f).read(352) if head == b"\x1f\x8b" else f.read(352)
    en = "<" if struct.unpack_from("<i", raw, 0)[0] == 348 else ">"
    dim = struct.unpack_from(en + "8h", raw, 40)
    shape = tuple(max(1, d) for d in dim[1 : 1 + max(dim[0], 3)])[::-1]
    while len(shape) > 3 and shape[0] == 1:
        shape = shape[1:]
    return shape


def write_nifti(
    path: str,
    array: np.ndarray,
    spacing=(1.0, 1.0, 1.0),
    origin=(0.0, 0.0, 0.0),
    direction: np.ndarray | None = None,
) -> None:
    """Write a (z, y, x) array as single-file NIfTI-1, gzip if .gz."""
    arr = np.ascontiguousarray(array)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.dtype not in _CODES:
        arr = arr.astype(np.float32)
    code = _CODES[arr.dtype]

    ndim = arr.ndim
    shape_xyz = arr.shape[::-1]
    dim = [ndim] + list(shape_xyz) + [1] * (7 - ndim)
    sp = [float(s) for s in spacing[:3]] + [1.0] * max(0, ndim - 3)
    pixdim = [1.0] + sp[:ndim] + [1.0] * (7 - ndim)

    direction = np.eye(3) if direction is None else np.asarray(direction, np.float64)
    rot = direction * np.asarray(spacing[:3], np.float64)[None, :]
    # LPS (ours) -> RAS (NIfTI): negate rows 0 and 1
    srow = np.zeros((3, 4))
    srow[:, :3] = rot * np.array([[-1.0], [-1.0], [1.0]])
    srow[:, 3] = (-origin[0], -origin[1], origin[2])

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl
    struct.pack_into("<b", hdr, 123, 32 | 2)  # xyzt_units: mm | sec
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform=0, sform=1
    struct.pack_into("<12f", hdr, 280, *srow.reshape(-1))
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + arr.tobytes()
    if path.endswith(".gz"):
        # mtime=0 for reproducible bytes
        with open(path, "wb") as f:
            with gzip.GzipFile(filename="", fileobj=f, mode="wb", mtime=0) as gz:
                gz.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
