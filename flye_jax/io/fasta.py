"""Byte-level FASTA/FASTQ(.gz) reading and writing.

Sequences are represented as NumPy uint8 arrays of 2-bit base codes
(A=0, C=1, G=2, T=3).  Ambiguity codes are sanitized to 'A' on input,
mirroring the reference pipeline's ACGT sanitization
(reference: flye/utils/fasta_parser.py).

Parsing is vectorized: the whole file is read into one bytes buffer and
translated through a 256-entry lookup table, so multi-GB read sets load
at memory bandwidth rather than Python-loop speed.
"""

from __future__ import annotations

import gzip
from typing import List, Tuple

import numpy as np

# base code translation table: byte value -> 2-bit code (or 0 for unknown)
_CODE_TABLE = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_TABLE[_b] = _i
    _CODE_TABLE[ord(chr(_b).lower())] = _i

_VALID = np.zeros(256, dtype=bool)
for _b in b"ACGTacgt":
    _VALID[_b] = True

_CODE_TO_BYTE = np.frombuffer(b"ACGT", dtype=np.uint8)

COMPLEMENT = np.array([3, 2, 1, 0], dtype=np.uint8)


def str_to_codes(s: str) -> np.ndarray:
    """ASCII sequence string -> uint8 code array (non-ACGT -> A)."""
    raw = np.frombuffer(s.encode(), dtype=np.uint8)
    return _CODE_TABLE[raw]


def codes_to_str(codes: np.ndarray) -> str:
    return _CODE_TO_BYTE[codes].tobytes().decode()


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT[codes[::-1]]


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _detect_fastq(path: str) -> bool:
    base = path[:-3] if path.endswith(".gz") else path
    if base.endswith((".fastq", ".fq")):
        return True
    if base.endswith((".fasta", ".fa", ".fna")):
        return False
    # sniff first byte
    with _open_maybe_gz(path) as f:
        first = f.read(1)
    return first == b"@"


def read_seq_file(path: str) -> List[Tuple[str, np.ndarray]]:
    """Read FASTA or FASTQ (optionally gzipped).

    Returns a list of (header, codes) where codes is a uint8 array of
    2-bit base codes. Header is the first whitespace token of the
    description line.
    """
    is_fastq = _detect_fastq(path)
    with _open_maybe_gz(path) as f:
        data = f.read()
    if not data:
        return []
    # native single-pass parser when the C++ helpers are available
    from flye_jax import native
    mod = native.get()
    if mod is not None:
        try:
            codes_b, offs_b, names = mod.pack_sequences(data,
                                                        int(is_fastq))
            arena = np.frombuffer(codes_b, dtype=np.uint8)
            offsets = np.frombuffer(offs_b, dtype=np.int64)
            return [(names[i], arena[offsets[i]:offsets[i + 1]])
                    for i in range(len(names))]
        except ValueError:
            raise ValueError(f"malformed FASTQ in {path}")
    out: List[Tuple[str, np.ndarray]] = []
    if is_fastq:
        lines = data.split(b"\n")
        n = len(lines)
        i = 0
        while i + 1 < n:
            hdr = lines[i]
            if not hdr:
                i += 1
                continue
            if not hdr.startswith(b"@"):
                raise ValueError(f"malformed FASTQ at line {i} in {path}")
            name = hdr[1:].split()[0].decode() if len(hdr) > 1 else ""
            seq = lines[i + 1]
            out.append((name, _sanitize(np.frombuffer(seq, dtype=np.uint8))))
            i += 4  # header, seq, '+', quals
    else:
        # split on '>' record markers; vectorized translate per record
        chunks = data.split(b">")
        for chunk in chunks[1:]:
            nl = chunk.find(b"\n")
            if nl < 0:
                continue
            name = chunk[:nl].split()[0].decode() if nl > 0 else ""
            seq = chunk[nl + 1:].replace(b"\n", b"").replace(b"\r", b"")
            out.append((name, _sanitize(np.frombuffer(seq, dtype=np.uint8))))
    return out


def _sanitize(raw: np.ndarray) -> np.ndarray:
    codes = _CODE_TABLE[raw]
    # invalid bytes already map to 0 ('A'); nothing else needed — but we
    # must drop any stray whitespace bytes that survived (FASTQ lines are
    # pre-split so this only guards \r)
    keep = raw != ord("\r")
    if not keep.all():
        codes = codes[keep]
    return codes.copy()


def write_fasta(records, path: str, width: int = 60) -> None:
    """Write (name, codes-or-str) records to a FASTA file."""
    with open(path, "w") as f:
        for name, seq in records:
            if isinstance(seq, np.ndarray):
                seq = codes_to_str(seq)
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width])
                f.write("\n")
