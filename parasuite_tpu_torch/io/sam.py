"""SAM text emission.

BASELINE.json:metric scores "% SAM-record concordance vs reference", so field
formatting is pinned down here in one place (SURVEY.md §7 "Hard parts" #1:
tie-breaks/MAPQ/CIGAR conventions are localized for calibration once the
reference mounts). Conventions, BWA-backtrack-shaped (upstream bwase.c):

  * no soft-clipping: the whole read is aligned (glocal), CIGAR in M/I/D;
  * reverse-strand records store the reverse-complemented SEQ and reversed
    QUAL with FLAG 0x10;
  * unmapped reads are emitted with FLAG 0x4, RNAME *, POS 0, CIGAR *;
  * tags: NM:i edit distance, AS:i alignment score, X0:i best-hit count,
    X1:i suboptimal-hit count, XT:A U(nique)/R(epeat).

Each host writes its own shard file; the merged SAM is a host-side
concatenation in deterministic shard order (SURVEY.md §5 "Distributed
communication backend") — SAM text never crosses the network.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from parasuite_tpu_torch import __version__
from parasuite_tpu_torch.index.reference import PackedReference
from parasuite_tpu_torch.utils.dna import decode_seq, revcomp_codes


def sam_header(ref: PackedReference, sort_order: str = "unsorted",
               command_line: str = "") -> str:
    lines = [f"@HD\tVN:1.6\tSO:{sort_order}"]
    for i, name in enumerate(ref.names):
        lines.append(f"@SQ\tSN:{name}\tLN:{ref.chrom_len(i)}")
    # the program name stays the reference's: the files are byte-identical
    pg = f"@PG\tID:parasuite_tpu\tPN:parasuite_tpu\tVN:{__version__}"
    if command_line:
        pg += f"\tCL:{command_line}"
    lines.append(pg)
    return "\n".join(lines) + "\n"


def cigar_string(cigar: list[tuple[str, int]]) -> str:
    if not cigar:
        return "*"
    return "".join(f"{ln}{op}" for op, ln in cigar)


def format_record(name: str, read_codes: np.ndarray, read_len: int,
                  qual: bytes, ref: PackedReference, *,
                  mapped: bool, strand: int = 0, packed_pos: int = -1,
                  mapq: int = 0, cigar=None, score: int = 0, nm: int = 0,
                  x0: int = 0, x1: int = 0, with_md: bool = True,
                  extra_tags: list | None = None) -> str:
    """One SAM line (no trailing newline).

    read_codes/qual are in machine (sequencing) orientation; this function
    applies the reverse-strand transform for emission.
    """
    codes = np.asarray(read_codes[:read_len])
    q = qual[:read_len].decode("ascii") if qual else "*"
    if not mapped:
        seq = decode_seq(codes)
        return "\t".join([name, "4", "*", "0", "0", "*", "*", "0", "0",
                          seq, q])
    ci_arr, local = ref.locate(np.asarray([packed_pos]))
    ci = int(ci_arr[0])
    assert ci >= 0, "mapped record with position outside any chromosome"
    rname = ref.names[ci]
    pos_1 = int(local[0]) + 1
    if strand == 1:
        seq = decode_seq(revcomp_codes(codes))
        q = q[::-1] if q != "*" else q
        flag = 16
    else:
        seq = decode_seq(codes)
        flag = 0
    xt = "U" if x0 == 1 else "R"
    tags = [f"XT:A:{xt}", f"NM:i:{nm}", f"X0:i:{x0}", f"X1:i:{x1}",
            f"AS:i:{score}"]
    if with_md:
        aligned = revcomp_codes(codes) if strand == 1 else np.asarray(codes)
        tags.append("MD:Z:" + md_tag(ref.seq, packed_pos, cigar, aligned))
    if extra_tags:
        tags.extend(extra_tags)
    return "\t".join([name, str(flag), rname, str(pos_1), str(mapq),
                      cigar_string(cigar), "*", "0", "0", seq, q] + tags)


def md_tag(ref_seq: np.ndarray, packed_pos: int, cigar: list[tuple[str, int]],
           aligned_read: np.ndarray) -> str:
    """MD:Z value (samtools convention: match run-lengths, mismatch ref
    bases, ^-prefixed deleted ref bases; I consumes no MD, N skips silently).

    aligned_read: ref-strand-oriented codes (revcomp'd for reverse hits),
    as aligned — upstream bwase.c emits the same tag for backtrack output.
    """
    from parasuite_tpu_torch.utils.dna import CODE_TO_BASE

    out: list[str] = []
    run = 0
    ri, qi = packed_pos, 0
    for op, ln in cigar:
        if op == "M":
            for k in range(ln):
                rb = int(ref_seq[ri + k])
                cb = int(aligned_read[qi + k])
                if rb == cb and rb < 4:
                    run += 1
                else:
                    out.append(str(run))
                    out.append(chr(CODE_TO_BASE[min(rb, 4)]))
                    run = 0
            ri += ln
            qi += ln
        elif op == "I":
            qi += ln
        elif op == "D":
            out.append(str(run))
            run = 0
            out.append("^" + "".join(chr(CODE_TO_BASE[min(int(b), 4)])
                                     for b in ref_seq[ri : ri + ln]))
            ri += ln
        elif op == "N":
            ri += ln
    out.append(str(run))
    return "".join(out)


def parse_cigar(cig: str) -> list[tuple[str, int]]:
    if cig == "*":
        return []
    out = []
    n = ""
    for ch in cig:
        if ch.isdigit():
            n += ch
        else:
            out.append((ch, int(n)))
            n = ""
    return out


def cigar_ref_span(cigar: list[tuple[str, int]]) -> int:
    """Reference bases consumed (M + D)."""
    return sum(ln for op, ln in cigar if op in "MDN=X")


def read_sam(path):
    """Parse a SAM file -> (header_lines, records).

    Each record is a dict with the 11 mandatory fields (POS int, FLAG int,
    MAPQ int, CIGAR parsed) plus a raw tags list. Used by the cluster-calling
    CLI to consume merged alignments (SURVEY.md §3.5).
    """
    headers, records = [], []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("@"):
                headers.append(line)
                continue
            f = line.split("\t")
            records.append({
                "qname": f[0], "flag": int(f[1]), "rname": f[2],
                "pos": int(f[3]), "mapq": int(f[4]),
                "cigar": parse_cigar(f[5]), "seq": f[9], "qual": f[10],
                "tags": f[11:],
            })
    return headers, records


class SamWriter:
    """Streaming SAM shard writer."""

    def __init__(self, path, ref: PackedReference, command_line: str = "",
                 write_header: bool = True):
        self.path = Path(path)
        self._fh = open(self.path, "w")
        if write_header:
            self._fh.write(sam_header(ref, command_line=command_line))
        self.ref = ref
        self.n_records = 0

    def write(self, line: str) -> None:
        self._fh.write(line + "\n")
        self.n_records += 1

    def write_block(self, data) -> None:
        """Pre-formatted newline-terminated records (native fast path);
        accepts the native formatter's raw bytes or str."""
        if isinstance(data, (bytes, bytearray)):
            data = data.decode("ascii")
        self._fh.write(data)
        self.n_records += data.count("\n")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def merge_shards(out_path, shard_paths: list, ref: PackedReference,
                 command_line: str = "") -> None:
    """Deterministic merge: header + shard bodies in given order.

    Shards are written headerless by the distributed pipeline; ordering by
    shard index (not arrival) is what makes output identical at any host
    count (SURVEY.md §4.5 determinism tests). NOTE: whole-body concatenation
    only reproduces single-host record ORDER when each shard holds a
    contiguous record range; the round-robin batch layout needs
    merge_shards_interleaved instead.
    """
    with open(out_path, "w") as out:
        out.write(sam_header(ref, command_line=command_line))
        for sp in shard_paths:
            with open(sp) as fh:
                for line in fh:
                    if not line.startswith("@"):
                        out.write(line)


def merge_shards_interleaved(out_path, shard_paths: list,
                             batch_records: list, ref: PackedReference,
                             command_line: str = "") -> int:
    """Merge round-robin batch shards back into global record order.

    batch_records[h] = records emitted per LOCAL batch on shard h. Global
    batch g lives on shard g % H as local batch g // H (io.fastq round-robin
    layout), so emitting batches in ascending global index reproduces the
    single-host byte stream exactly — the SURVEY.md §4.5 determinism
    property ("same reads, any shard count -> identical SAM bytes").
    Returns the merged record count.
    """
    H = len(shard_paths)
    counts = [list(map(int, c)) for c in batch_records]
    if len(counts) != H:
        raise ValueError("batch_records must have one list per shard")
    n_batches = [len(c) for c in counts]
    total_batches = sum(n_batches)
    n_out = 0
    handles = [open(sp, "rb") for sp in shard_paths]
    try:
        with open(out_path, "wb") as out:
            out.write(sam_header(ref, command_line=command_line)
                      .encode("ascii"))
            g = 0
            emitted = 0
            while emitted < total_batches:
                h = g % H
                local = g // H
                g += 1
                if local >= n_batches[h]:
                    continue
                emitted += 1
                fh = handles[h]
                for _ in range(counts[h][local]):
                    line = fh.readline()
                    while line.startswith(b"@"):  # defensive: skip headers
                        line = fh.readline()
                    if not line:
                        raise RuntimeError(
                            f"shard {shard_paths[h]} shorter than its "
                            "manifest batch_records")
                    out.write(line)
                    n_out += 1
            for h, fh in enumerate(handles):
                rest = fh.read()
                if rest.strip():
                    raise RuntimeError(
                        f"shard {shard_paths[h]} has records beyond its "
                        "manifest batch_records")
    finally:
        for fh in handles:
            fh.close()
    return n_out
