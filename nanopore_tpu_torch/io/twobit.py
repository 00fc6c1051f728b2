"""Minimal UCSC .2bit writer.

A copy of the JAX package's ``io/twobit.py``.

Replaces the ``faToTwoBit`` binary the reference assembly-hub generator
shells out to (reference nanopore/metaAnalyses/
customTrackAssemblyHub.py:83).  Format per the UCSC spec: little-endian
header (signature 0x1A412743, version 0, count, reserved), name index,
then per-sequence records with N-block and (empty) mask-block tables and
2-bit packed bases (T=0, C=1, A=2, G=3).
"""

from __future__ import annotations

import struct

import numpy as np

from nanopore_tpu_torch.io.encoding import encode

_SIGNATURE = 0x1A412743
# 2bit base codes: T=0, C=1, A=2, G=3 (UCSC order)
_CODE_TO_2BIT = np.array([2, 1, 3, 0, 0], dtype=np.uint8)  # ACGTN -> 2bit


def write_2bit(sequences: dict[str, str], path: str) -> None:
    names = list(sequences.keys())
    with open(path, "wb") as fh:
        fh.write(struct.pack("<IIII", _SIGNATURE, 0, len(names), 0))
        # name index: offsets filled after layout computation
        index_pos = fh.tell()
        name_blobs = []
        for name in names:
            raw = name.encode("ascii")
            assert len(raw) < 256
            name_blobs.append(raw)
        index_size = sum(1 + len(b) + 4 for b in name_blobs)
        offset = index_pos + index_size
        offsets = []
        payloads = []
        for name in names:
            seq = sequences[name]
            codes = encode(seq)
            n = len(codes)
            # N blocks: runs of code 4
            is_n = codes == 4
            if is_n.any():
                d = np.diff(is_n.astype(np.int8))
                starts = np.nonzero(d == 1)[0] + 1
                ends = np.nonzero(d == -1)[0] + 1
                if is_n[0]:
                    starts = np.concatenate([[0], starts])
                if is_n[-1]:
                    ends = np.concatenate([ends, [n]])
                n_starts = starts.astype(np.uint32)
                n_sizes = (ends - starts).astype(np.uint32)
            else:
                n_starts = np.empty(0, np.uint32)
                n_sizes = np.empty(0, np.uint32)
            two = _CODE_TO_2BIT[codes]
            pad = (-n) % 4
            if pad:
                two = np.concatenate([two, np.zeros(pad, np.uint8)])
            packed = (
                (two[0::4] << 6) | (two[1::4] << 4) | (two[2::4] << 2)
                | two[3::4]
            ).astype(np.uint8)
            payload = struct.pack("<I", n)
            payload += struct.pack("<I", len(n_starts))
            payload += n_starts.astype("<u4").tobytes()
            payload += n_sizes.astype("<u4").tobytes()
            payload += struct.pack("<I", 0)  # maskBlockCount
            payload += struct.pack("<I", 0)  # reserved
            payload += packed.tobytes()
            payloads.append(payload)
            offsets.append(offset)
            offset += len(payload)
        for blob, off in zip(name_blobs, offsets):
            fh.write(struct.pack("<B", len(blob)))
            fh.write(blob)
            fh.write(struct.pack("<I", off))
        for payload in payloads:
            fh.write(payload)


def read_2bit_names(path: str) -> dict[str, int]:
    """Read back (name -> length) for verification."""
    with open(path, "rb") as fh:
        sig, version, count, _ = struct.unpack("<IIII", fh.read(16))
        assert sig == _SIGNATURE, "bad 2bit signature"
        entries = []
        for _ in range(count):
            (name_len,) = struct.unpack("<B", fh.read(1))
            name = fh.read(name_len).decode("ascii")
            (off,) = struct.unpack("<I", fh.read(4))
            entries.append((name, off))
        out = {}
        for name, off in entries:
            fh.seek(off)
            (length,) = struct.unpack("<I", fh.read(4))
            out[name] = length
    return out
