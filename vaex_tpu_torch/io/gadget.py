"""Gadget N-body snapshots (vaex_tpu/io/gadget.py): Fortran record files,
each block framed by 4-byte lengths, in SnapFormat 2 behind a 16-byte
descriptor; the 256-byte header holds the particle counts, positions and
velocities follow as float32 triplets.  The columns are strided memory maps
of the file: opening reads no particle."""

from __future__ import annotations

import struct

import numpy as np

from ..column import file_identity
from ..dataset import DatasetFile

_HEADER = "=6I6dddii6iiiddddii6ii60x"  # 256 bytes
_HEADER_SIZE = 256


def read_header(path):
    """(particles, offset of the positions, offset of the velocities, the
    header) of a format 1 or 2 snapshot."""
    with open(path, "rb") as f:
        fmt2 = struct.unpack("I", f.read(4))[0] == 8
        f.seek((16 if fmt2 else 0) + 4)
        raw = struct.unpack(_HEADER, f.read(_HEADER_SIZE))
    header = {
        "Npart": raw[0:6], "Massarr": raw[6:12], "Time": raw[12],
        "Redshift": raw[13], "FlagSfr": raw[14], "FlagFeedback": raw[15],
        "Nall": raw[16:22], "FlagCooling": raw[22], "NumFiles": raw[23],
        "BoxSize": raw[24], "Omega0": raw[25], "OmegaLambda": raw[26],
        "HubbleParam": raw[27],
    }
    n = int(sum(header["Npart"]))
    desc = 16 if fmt2 else 0
    pos = desc + 4 + _HEADER_SIZE + 4 + desc + 4
    vel = pos + 3 * 4 * n + 4 + desc + 4
    return n, pos, vel, header


def is_gadget(path):
    """Whether the file has a snapshot's record structure."""
    try:
        with open(path, "rb") as f:
            words = struct.unpack("4I", f.read(16))
            if words[0] == 8 and (words[3] == 8 or (words[2] == 8 and words[3] == _HEADER_SIZE)):
                return True
            if words[0] == _HEADER_SIZE:
                f.seek(4 + _HEADER_SIZE)
                return struct.unpack("I", f.read(4))[0] == _HEADER_SIZE
    except (struct.error, OSError):
        return False
    return False


class GadgetDataset(DatasetFile):
    """x, y, z, vx, vy, vz as strided float32 memory maps."""

    def __init__(self, path):
        n, pos, vel, header = read_header(path)
        with open(path, "rb") as fh:
            super().__init__(path, file_identity(path, fh.fileno()))
            self.gadget_header = header
            for base, names in ((pos, ("x", "y", "z")), (vel, ("vx", "vy", "vz"))):
                block = np.memmap(fh, dtype=np.float32, mode="r", offset=base, shape=(3 * n,))
                for i, name in enumerate(names):
                    self.add_column(name, block[i::3])


def open_gadget(path):
    from .. import from_dataset
    return from_dataset(GadgetDataset(path))
