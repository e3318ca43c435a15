"""Repeat-structured synthetic reference genomes (VERDICT r4 next-round #1).

A copy of parasuite_tpu/sim/genome.py (that package imports jax when it is
imported), pinned to it by tests/test_torch_modes.py. Pure numpy.

Every prior bench/sweep ran on uniform-random sequence, where k=12 seeds
collide with probability ~G/4^24 and max_occ never triggers. A real genome
(BASELINE config 1 names hg19 chr22) is dominated by interspersed repeat
families — the exact thing the seeding max_occ policy, X0/X1 counting, and
MAPQ exist for. This module builds deterministic synthetic chromosomes with
the repeat census of a human chromosome arm so those paths can be measured
at realistic scale without a FASTA source (no network; the reference mount
is empty — SURVEY.md header):

  * SINE-like family: ~300 bp consensus, thousands of copies, per-copy
    divergence 2-20% + 5' truncation (the Alu census: ~10% of the genome);
  * LINE-like family: 6 kb consensus, mostly 5'-truncated copies, 5-25%
    divergence (~8-17% of real chromosomes);
  * LTR-like family: 1.5 kb, moderate copy count;
  * satellite arrays: tandem ~171 bp monomers with small per-monomer
    divergence (alphoid-like), placed near the N gap;
  * segmental duplications: a few 50-200 kb blocks duplicated once at 2-5%
    divergence — the hardest case for uniqueness (X1 hits at high score);
  * N gaps: a leading centromeric block plus scattered internal gaps
    (chr22 is acrocentric: ~10.5 Mbp of its 51 Mbp is N in hg19).

Background sequence is i.i.d. uniform ACGT. GC skew and CpG structure are
NOT modeled — they shift k-mer bucket-occupancy tails somewhat but do not
change the repeat-driven max_occ/uniqueness behavior this exists to test.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class RepeatFamily:
    name: str
    consensus_len: int
    n_copies: int
    divergence_lo: float
    divergence_hi: float
    truncate: bool = True       # sample a 5'-truncated suffix per copy
    min_len: int = 60


@dataclass
class GenomeStats:
    """Per-chromosome synthesis accounting (repeat fraction drives the
    max_occ story in tools/bench_genome.py)."""

    length: int = 0
    n_bases: int = 0
    repeat_bases: int = 0
    family_bases: dict = field(default_factory=dict)

    @property
    def repeat_fraction(self) -> float:
        eff = self.length - self.n_bases
        return self.repeat_bases / max(eff, 1)


CHR22_FAMILIES = (
    RepeatFamily("SINE_alu", 300, 13_000, 0.02, 0.20),
    RepeatFamily("LINE_l1", 6_000, 900, 0.05, 0.25),
    RepeatFamily("LTR_erv", 1_500, 1_100, 0.04, 0.20),
)


def _mutate(rng: np.random.Generator, seq: np.ndarray,
            divergence: float) -> np.ndarray:
    """Substitute each base i.i.d. with probability `divergence` (new base
    drawn uniformly from the 3 others — a real substitution, never a
    no-op)."""
    m = rng.random(seq.shape[0]) < divergence
    if not m.any():
        return seq
    out = seq.copy()
    out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
    return out.astype(np.int8)


def synth_chromosome(length: int, seed: int,
                     families: tuple = CHR22_FAMILIES,
                     n_gap_lead: int = 0,
                     n_gap_internal: int = 0,
                     satellite_bases: int = 0,
                     segdup_blocks: int = 0,
                     stats: GenomeStats | None = None) -> np.ndarray:
    """-> int8 codes [length] (0..3 bases, 4 = N). Deterministic in seed."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, length).astype(np.int8)
    st = stats if stats is not None else GenomeStats()
    st.length += length

    lo = n_gap_lead  # sequence space starts after the leading N block

    # interspersed families: paste diverged (possibly truncated) copies
    for fam in families:
        cons = rng.integers(0, 4, fam.consensus_len).astype(np.int8)
        placed = 0
        for _ in range(fam.n_copies):
            if fam.truncate:
                ln = int(rng.integers(fam.min_len, fam.consensus_len + 1))
            else:
                ln = fam.consensus_len
            pos = int(rng.integers(lo, length - ln))
            div = float(rng.uniform(fam.divergence_lo, fam.divergence_hi))
            seq[pos:pos + ln] = _mutate(rng, cons[-ln:], div)
            placed += ln
        st.repeat_bases += placed
        st.family_bases[fam.name] = st.family_bases.get(fam.name, 0) + placed

    # satellite: tandem monomer array right after the leading gap
    if satellite_bases > 0:
        mono = rng.integers(0, 4, 171).astype(np.int8)
        p = lo
        placed = 0
        while p + 171 <= lo + satellite_bases:
            seq[p:p + 171] = _mutate(rng, mono, 0.05)
            p += 171
            placed += 171
        st.repeat_bases += placed
        st.family_bases["satellite"] = \
            st.family_bases.get("satellite", 0) + placed

    # segmental duplications: copy a large existing block once, 2-5% diverged
    for _ in range(segdup_blocks):
        ln = int(rng.integers(50_000, 200_000))
        src = int(rng.integers(lo, length - ln))
        dst = int(rng.integers(lo, length - ln))
        seq[dst:dst + ln] = _mutate(rng, seq[src:src + ln].copy(),
                                    float(rng.uniform(0.02, 0.05)))
        st.repeat_bases += ln
        st.family_bases["segdup"] = st.family_bases.get("segdup", 0) + ln

    # N gaps LAST so nothing overwrites them (reads never sample N windows)
    if n_gap_lead > 0:
        seq[:n_gap_lead] = 4
        st.n_bases += n_gap_lead
    for _ in range(n_gap_internal):
        ln = int(rng.integers(20_000, 100_000))
        pos = int(rng.integers(lo, length - ln))
        seq[pos:pos + ln] = 4
        st.n_bases += ln  # approximate (overlapping gaps double-count)

    return seq


def chr22_like(seed: int = 22, scale: float = 1.0):
    """-> ({name: codes}, GenomeStats): a chr22-class chromosome — 51 Mbp
    with a ~10.3 Mbp leading N block (acrocentric arm), ~40 Mbp of
    repeat-structured sequence (~25% interspersed repeats + satellite +
    segdups). `scale` shrinks everything proportionally for tests."""
    length = int(51_000_000 * scale)
    fams = tuple(
        RepeatFamily(f.name, f.consensus_len,
                     max(1, int(f.n_copies * scale)),
                     f.divergence_lo, f.divergence_hi)
        for f in CHR22_FAMILIES)
    stats = GenomeStats()
    seq = synth_chromosome(
        length, seed, families=fams,
        n_gap_lead=int(10_300_000 * scale),
        n_gap_internal=max(0, int(4 * scale)),
        satellite_bases=int(200_000 * scale),
        segdup_blocks=max(1, int(3 * scale)),
        stats=stats)
    return {"chr22s": seq}, stats


def multi_chrom(total_len: int, n_chroms: int, seed: int = 7,
                repeat_scale: float = 0.6):
    """-> ({name: codes}, GenomeStats): an n-chromosome genome of total_len
    with per-chromosome repeat families scaled to `repeat_scale` x the
    chr22 census density (genome-wide average is lighter than chr22's arm).
    Used for the >=200 Mbp single-chip and 2-D sharded footprint benches."""
    per = total_len // n_chroms
    stats = GenomeStats()
    out = {}
    for c in range(n_chroms):
        density = per / 40_700_000  # family counts scale with length
        fams = tuple(
            RepeatFamily(f.name, f.consensus_len,
                         max(1, int(f.n_copies * density * repeat_scale)),
                         f.divergence_lo, f.divergence_hi)
            for f in CHR22_FAMILIES)
        out[f"chr{c + 1}"] = synth_chromosome(
            per, seed + c, families=fams,
            n_gap_internal=2, segdup_blocks=1, stats=stats)
    return out, stats
