"""FASTA reader/writer (host-side).

The reference toolkit reads references via htsjdk/samtools-style FASTA access
(SURVEY.md §2 component 9); here a minimal streaming parser producing int8
code arrays (utils.dna encoding) is all the engine needs.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

from parasuite_tpu_torch.utils.dna import decode_seq, encode_seq


def _open(path, mode="rb"):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, mode)
    return open(path, mode)


def read_fasta(path) -> dict[str, np.ndarray]:
    """Parse FASTA -> ordered {name: int8 codes}. Name = first whitespace token."""
    out: dict[str, np.ndarray] = {}
    name = None
    chunks: list[bytes] = []
    with _open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    out[name] = encode_seq(b"".join(chunks))
                name = line[1:].split()[0].decode("ascii")
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        out[name] = encode_seq(b"".join(chunks))
    return out


def write_fasta(path, seqs: dict[str, np.ndarray], width: int = 70) -> None:
    """Write {name: int8 codes} as FASTA."""
    with _open(path, "wb") as fh:
        for name, codes in seqs.items():
            fh.write(b">" + name.encode("ascii") + b"\n")
            s = decode_seq(codes).encode("ascii")
            for i in range(0, len(s), width):
                fh.write(s[i : i + width] + b"\n")
