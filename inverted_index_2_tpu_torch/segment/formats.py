"""On-disk segment format.

A segment is two files (mirroring the reference's `<unixnano>_fst` +
`<unixnano>_val` pair, file/writer.go:97-137):

    <key>_dict   term dictionary: header + offsets + outs + term blob
    <key>_vals   packed posting words (absent in direct mode)

where <key> is time.time_ns() as a decimal string (writer.go:98). Files are
written as `<name>_tmp` and published by atomic os.rename (writer.go:79-86),
giving the same crash-consistency: a crash leaves only `*_tmp` litter which
loaders ignore (shard.go:312).

_dict layout (little-endian):
    u32 magic   = 0x54504931 ("TPI1")
    u32 version = 1
    u32 mode    (0 = normal: outs are word offsets into _vals;
                 1 = direct: outs ARE the single posting value --
                 the reference's direct mode stores the value as the FST
                 output, writer.go:35)
    u32 n_terms
    u64 blob_len
    u64 reserved
    u64 offsets[n_terms+1]   byte offsets into blob (sorted terms)
    u64 outs[n_terms]
    u8  blob[blob_len]

Terms are unique and sorted ascending by bytes.Compare; min/max term are
offsets[0]/offsets[-1] slices (no separate metadata file; the reference also
re-derives count/min/max from the FST at load, shard.go:318-334).
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

MAGIC = 0x54504931
VERSION = 1
MODE_NORMAL = 0
MODE_DIRECT = 1

DICT_SUFFIX = "_dict"
VALS_SUFFIX = "_vals"
TMP_SUFFIX = "_tmp"

_HEADER = struct.Struct("<IIII QQ")
HEADER_SIZE = _HEADER.size


# flags (stored in the header's former reserved word): compact array dtypes
FLAG_OFFSETS_U32 = 1  # term byte offsets stored as u32 (blob < 4 GiB)
FLAG_OUTS_U32 = 2     # outs stored as u32 (direct values, or small vals file)
FLAG_OUTS_CONST = 4   # all outs equal: region holds ONE value (direct-mode
                      # ingest — the reference's DirectWriter also stores one
                      # value per Put batch, shard.go:33-67)
FLAG_FIXED_WIDTH = 8  # all terms same length: offsets region holds ONE value
                      # (the width); offsets[i] = i * width


@dataclass
class DictHeader:
    mode: int
    n_terms: int
    blob_len: int
    flags: int = 0


def pack_header(mode: int, n_terms: int, blob_len: int, flags: int = 0) -> bytes:
    return _HEADER.pack(MAGIC, VERSION, mode, n_terms, blob_len, flags)


def write_header(f, mode: int, n_terms: int, blob_len: int, flags: int = 0) -> None:
    f.write(pack_header(mode, n_terms, blob_len, flags))


def read_header(buf: bytes) -> DictHeader:
    magic, version, mode, n_terms, blob_len, flags = _HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ValueError("bad segment dict magic")
    if version != VERSION:
        raise ValueError(f"unsupported segment version {version}")
    if mode not in (MODE_NORMAL, MODE_DIRECT):
        raise ValueError(f"corrupt segment dict mode {mode}")
    return DictHeader(mode=mode, n_terms=n_terms, blob_len=blob_len, flags=flags)


def dict_path(basedir: str, key: str) -> str:
    return os.path.join(basedir, key + DICT_SUFFIX)


def vals_path(basedir: str, key: str) -> str:
    return os.path.join(basedir, key + VALS_SUFFIX)


def is_dict_file(name: str) -> bool:
    return name.endswith(DICT_SUFFIX)


def key_of_dict_file(name: str) -> str:
    return name[: -len(DICT_SUFFIX)]


def remove_segment(basedir: str, key: str) -> None:
    """Unlink both segment files, tolerating absence
    (parity with file/writer.go:140-147)."""
    for p in (dict_path(basedir, key), vals_path(basedir, key)):
        try:
            os.remove(p)
        except FileNotFoundError:
            pass
