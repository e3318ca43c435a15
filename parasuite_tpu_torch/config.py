"""Single source of truth for alignment / pipeline configuration.

SURVEY.md §5 ("Config/flag system"): the reference exposes per-tool CLI flags
(seed length, max diffs, conversion thresholds, cluster min-reads); here they
live in one serializable dataclass that is written alongside every output for
reproducibility. All scoring is integer (SURVEY.md §7 "Exactness discipline"),
mirroring BWA's integer penalties (upstream bwtaln.c), so results are
bit-identical across batch sizes, shard counts, and vs the CPU oracle.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class AlignConfig:
    """Configuration for the seed-and-extend aligner and pipeline.

    The flat-model scores express BWA-backtrack's ~1:3 match:mismatch penalty
    ratio (upstream bwtaln.c defaults) on an integer log-odds scale; the
    profile-aware pass replaces the substitution scores with a learned
    S[read_pos, ref_base, read_base] tensor of the same dtype/scale
    (BASELINE.json:north_star).
    """

    # --- read geometry ---
    max_read_len: int = 100          # L: pad-to length (reads are 36-100bp [B])
    batch_size: int = 1024           # reads per device batch (B)

    # --- seeding (k-mer hash index; SURVEY.md §7 "Seeding") ---
    kmer_size: int = 12              # k (k=11 measured WORSE: random-hit
                                     # crowding evicts true diagonals from
                                     # top-C — SWEEP_TWOPASS_r03.jsonl)
    max_seeds: int = 7               # seeds per read at offsets s*stride
    seed_stride: int = 6             # offset step between seeds. The 7/6
                                     # overlapping layout is the decided
                                     # operating point (BASELINE.md
                                     # "Sensitivity operating point"):
                                     # sensitivity 0.9916 vs 0.9873 for the
                                     # non-overlapping 4/12 layout at ~15%
                                     # device throughput cost; an error must
                                     # dirty every one of 7 windows to hide
                                     # a locus. 4/12 (max_seeds=4,
                                     # seed_stride=0) remains the speed point
    seed_placement: str = "adaptive" # "adaptive": per-read stride
                                     # max(1, (len-k)//(max_seeds-1)) —
                                     # spreads the max_seeds windows evenly
                                     # over EACH read's true length, so 36bp
                                     # reads still place all seeds and 100bp
                                     # reads cover their full span (the spec
                                     # range is 36-100bp, BASELINE.md). At
                                     # the adopted defaults and L=50 this
                                     # reduces to stride 6 — bit-identical
                                     # to round 3's operating point (and to
                                     # 12 for the 4-seed speed point).
                                     # "fixed": offsets s*seed_stride
                                     # regardless of read length (round-3
                                     # behavior)
    max_occ: int = 64                # skip seeds whose k-mer occurs more often
    max_candidates: int = 16         # C: candidate diagonals kept per read/strand
    rescue_kmer: int = 0             # two-tier seeding (VERDICT r4 weak #5):
                                     # when > 0, reads the primary pass leaves
                                     # UNMAPPED retry through a second device
                                     # pass seeded at this smaller k (same
                                     # scoring/DP; pipeline/align.py
                                     # _dispatch_rescue / _finish_rescue).
                                     # Targets the 36bp tail
                                     # where 1% of stress-model reads have no
                                     # error-free 12-mer (SWEEP_LENGTHS_r04:
                                     # seeding-information ceiling 0.9898).
                                     # 0 = off (the default operating point
                                     # is unchanged and bit-identical)
    rescue_seeds: int = 13           # seeds per read in the rescue pass
                                     # (only with rescue_kmer > 0): the
                                     # rescue batch is a few % of reads and
                                     # its cost is dispatch-latency-bound,
                                     # so denser placement is nearly free
                                     # there — 13 seeds at stride
                                     # (36-11)//12 = 2 approximates
                                     # all-offset coverage on 36bp reads

    # --- extension (banded affine-gap DP; SURVEY.md §7 "Extension/scoring") ---
    band_width: int = 5              # W: max net indel; band = 2W+1 diagonals
    match_score: int = 6             # flat-model match (int log-odds scale)
    mismatch_score: int = -18        # flat-model mismatch
    n_score: int = -6                # any comparison involving N
    gap_open: int = 45               # penalty for first gap base (open+extend)
    gap_extend: int = 15             # penalty per additional gap base
    min_score_frac: float = 0.3      # unmapped if best < frac * Lr * match_score

    # --- error profile (SURVEY.md §2 component 3) ---
    profile_scale: float = 3.0       # log-odds -> int scale for learned S
    profile_min_score: int = -54     # clip for learned substitution scores
    profile_max_score: int = 12      # clip (matches stay positive)
    profile_pseudocount: float = 0.5 # additive smoothing for count matrices

    # --- simulator defaults (SURVEY.md §2 component 8) ---
    sim_tc_rate: float = 0.125       # P(T->C conversion) at crosslink positions
    sim_error_rate: float = 0.002    # base sequencing error rate (flat fallback)

    # --- cluster calling (SURVEY.md §2 component 11) ---
    cluster_min_reads: int = 2       # drop clusters with fewer reads
    cluster_min_tc: int = 1          # require >=1 T->C conversion in cluster

    # --- combined genome+transcriptome mode (SURVEY.md §2 component 7) ---
    combined_wire_cap: float = 1.0   # packed-wire candidate entries per read
                                     # (ops/aligner.PackedCandidates): the
                                     # device ships cap*batch_size compacted
                                     # entries for rows the in-step genome
                                     # projection could NOT fully resolve
                                     # (junction-spanning/gapped/off-end
                                     # candidates — a few % of reads, ~2-3
                                     # entries each); a batch needing more
                                     # falls back to the unpacked step
                                     # (correct, slower)
    combined_wire_jun_cap: float = 0.5  # junction winners per read the wire
                                     # can carry (row + spliced offset, 8 B
                                     # each — the host only assembles their
                                     # N CIGARs); overflow falls back to
                                     # the unpacked step

    # --- misc ---
    chrom_spacer: int = 256          # N bases packed between chroms (> L + 2W,
                                     # so no alignment window straddles chroms)
    seed: int = 0                    # PRNG seed for simulation
    extend_impl: str = "auto"        # extension / candidate-select stage
    select_impl: str = "auto"        # (ops/aligner.resolve_*_fn): "auto" the
                                     # Hopper kernel on CUDA tensors and the
                                     # plain version on CPU tensors;
                                     # "pallas" the kernel, and CPU tensors
                                     # raise; "jnp" the plain version on
                                     # every device (the JAX package's names
                                     # and values, so the config JSON and
                                     # cfg_hash stay equal)

    def __post_init__(self) -> None:
        if self.chrom_spacer < self.max_read_len + 2 * self.band_width:
            raise ValueError("chrom_spacer must exceed max_read_len + 2*band_width")
        if self.seed_stride < 0:
            raise ValueError("seed_stride must be >= 0 (0 = kmer_size)")
        if self.seed_placement not in ("adaptive", "fixed"):
            raise ValueError("seed_placement must be 'adaptive' or 'fixed'")
        if self.seed_placement == "fixed" and \
                (self.max_seeds - 1) * self.stride + self.kmer_size > self.max_read_len:
            raise ValueError("seed offsets must fit in max_read_len")
        if self.kmer_size > 15:
            raise ValueError("kmer_size > 15 overflows int32 k-mer codes")
        if self.rescue_kmer and not (6 <= self.rescue_kmer < self.kmer_size):
            raise ValueError("rescue_kmer must be 0 (off) or in "
                             "[6, kmer_size)")
        if self.rescue_kmer and self.rescue_seeds < 1:
            raise ValueError("rescue_seeds must be >= 1")
        # the extend kernel ships per-base scores as int8 (ops/cuda_extend)
        for f in ("match_score", "mismatch_score", "n_score",
                  "profile_min_score", "profile_max_score"):
            v = getattr(self, f)
            if not (-128 <= v <= 127):
                raise ValueError(f"{f}={v} does not fit the kernel's int8 "
                                 "score feed")
        if self.band > 16:
            raise ValueError("band (2*band_width+1) exceeds the kernel's "
                             "16-sublane band tile")

    @property
    def stride(self) -> int:
        """Effective seed offset step (seed_stride, or k when 0)."""
        return self.seed_stride if self.seed_stride > 0 else self.kmer_size

    def seed_stride_for(self, read_len: int) -> int:
        """Effective seed stride for a read of this length (the adaptive
        per-read spread, or the fixed stride)."""
        if self.seed_placement == "adaptive" and self.max_seeds > 1:
            return max(1, (read_len - self.kmer_size) // (self.max_seeds - 1))
        return self.stride

    @property
    def band(self) -> int:
        """Number of diagonals in the DP band (2W+1)."""
        return 2 * self.band_width + 1

    def min_score(self, read_len: int) -> int:
        """Minimum alignment score to report a read as mapped."""
        return int(self.min_score_frac * read_len * self.match_score)

    # --- serialization (outputs carry their config for reproducibility) ---
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "AlignConfig":
        return cls(**json.loads(text))

    def replace(self, **kw) -> "AlignConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = AlignConfig()
