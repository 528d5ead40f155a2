"""ctypes bindings to the optional C++ IO accelerator.

The runtime around the device compute path (file parsing, formatted output)
is implemented natively in ``lightdock_tpu/native/io_native.cpp`` —
mirroring the reference's native (Rust) runtime — and loaded here via
ctypes.  Everything degrades gracefully to the pure-Python implementations
when the shared library has not been built; the first import attempts an
on-demand ``make`` build (cached).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libio_native.so"

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("LIGHTDOCK_TPU_NO_NATIVE"):
        return None
    try:
        if not _LIB_PATH.exists():
            subprocess.run(
                ["make", "-s", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        _lib = ctypes.CDLL(str(_LIB_PATH))
        _configure(_lib)
    except Exception as exc:  # noqa: BLE001 - any failure => pure-Python path
        print(f"lightdock_tpu: native IO unavailable ({exc!r}); "
              "using pure-Python IO", file=sys.stderr)
        _lib = None
    return _lib


def available() -> bool:
    """True when the native IO library is loaded (built on first use)."""
    return _load() is not None


def _configure(lib) -> None:
    lib.ld_parse_pdb.restype = ctypes.c_void_p
    lib.ld_parse_pdb.argtypes = [ctypes.c_char_p]
    lib.ld_pdb_natoms.restype = ctypes.c_int64
    lib.ld_pdb_natoms.argtypes = [ctypes.c_void_p]
    lib.ld_pdb_coords.restype = ctypes.POINTER(ctypes.c_double)
    lib.ld_pdb_coords.argtypes = [ctypes.c_void_p]
    lib.ld_pdb_strings.restype = ctypes.c_char_p
    lib.ld_pdb_strings.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ld_pdb_free.restype = None
    lib.ld_pdb_free.argtypes = [ctypes.c_void_p]
    lib.ld_write_gso.restype = ctypes.c_int
    lib.ld_write_gso.argtypes = [
        ctypes.c_char_p,                    # path
        ctypes.POINTER(ctypes.c_double),    # poses (G, pose_dim)
        ctypes.c_int64, ctypes.c_int64,     # G, pose_dim
        ctypes.POINTER(ctypes.c_double),    # luciferin
        ctypes.POINTER(ctypes.c_int64),     # num_neighbors
        ctypes.POINTER(ctypes.c_double),    # vision
        ctypes.POINTER(ctypes.c_double),    # scoring
    ]


def parse_pdb(path: str):
    """Native PDB parse; returns Structure field tuple or None."""
    lib = _load()
    if lib is None:
        return None
    import numpy as np

    handle = lib.ld_parse_pdb(path.encode())
    if not handle:
        return None
    try:
        n = lib.ld_pdb_natoms(handle)
        coords_ptr = lib.ld_pdb_coords(handle)
        coords = np.ctypeslib.as_array(coords_ptr, shape=(n, 3)).copy()
        columns = []
        for which in range(4):  # atom_names, res_names, res_ids, chain_ids
            blob = lib.ld_pdb_strings(handle, which)
            columns.append(blob.decode().split("\x1f") if n else [])
        atom_names, res_names, res_ids, chain_ids = columns
        if any(len(c) != n for c in columns):
            return None
        return atom_names, res_names, res_ids, chain_ids, coords
    finally:
        lib.ld_pdb_free(handle)


def write_gso(path: str, poses, luciferin, num_neighbors, vision, scoring) -> bool:
    """Native gso_N.out writer; returns False when unavailable."""
    lib = _load()
    if lib is None:
        return False
    import numpy as np

    poses = np.ascontiguousarray(poses, dtype=np.float64)
    luciferin = np.ascontiguousarray(luciferin, dtype=np.float64)
    nn = np.ascontiguousarray(num_neighbors, dtype=np.int64)
    vision = np.ascontiguousarray(vision, dtype=np.float64)
    scoring = np.ascontiguousarray(scoring, dtype=np.float64)
    g, pose_dim = poses.shape
    rc = lib.ld_write_gso(
        path.encode(),
        poses.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        g,
        pose_dim,
        luciferin.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nn.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vision.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        scoring.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return rc == 0
