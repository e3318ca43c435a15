"""Chromosome-sharded reference index (BASELINE.json: "replicated (or
sharded by chromosome) across hosts").

Counterpart of parasuite_tpu/parallel/shards.py. For references too large
for one packed index (the packed positions are int32, whatever the card's
memory: a 3 Gbp genome overflows them), chromosomes are partitioned across
an 'index' mesh axis; every read batch goes to each shard of its data row,
each shard aligns against its sub-reference with the same align_batch as the
replicated path, and the per-read best hit is reduced across shards:

  * winner  = (score desc, strand asc, ORIGINAL global position asc) — the
    same tie-break order as the replicated path, using original-packing
    coordinates so shard assignment cannot change the choice;
  * x0/x1 merge exactly: x0_g = sum of shard x0 at the winning score,
    x1_g = sum of all shard uniques - x0_g; MAPQ recomputed from the merged
    counts (integer table, ops/device_index._mapq_table).

Repeat filtering (cfg.max_occ) is GLOBAL: build_sharded_index sums per-shard
bucket counts (exact — spacer Ns mean no k-mer spans a chromosome boundary,
so shard counts partition the replicated count) and empties every shard's
bucket for any k-mer whose GLOBAL occurrence count exceeds cfg.max_occ. The
seeding stage's per-shard `cnt <= max_occ` check is then always consistent
with the replicated path, so a globally-repetitive k-mer can never survive
on a shard where it is locally rare (tests/test_torch_shards.py covers a
repeat-rich reference). Build-time and align-time cfg.max_occ must match;
ShardedIndex.slabs(cfg) enforces it (raises on mismatch).

The shard axis composes with the data axis: a 2-D ('data', 'index') mesh runs
read-batch parallelism and index parallelism together (make_sharded_step).
The step is one process over the mesh's devices, as in the reference (its
multi-process mode never uses the index axis): where the reference
all_gathers the per-shard results along the index axis, the step moves them
to the first device of the data row and stacks them there.

Equality contract: bit-equality with the replicated path holds while the
replicated per-read candidate list has headroom
(tests/test_torch_shards.py pins it, and holds the step to the reference's
sharded step field by field). On repeat-crowded references the replicated
list saturates (n_candidates == 2C) and top-C selection evicts true
diagonals; each shard keeps its own top-C, so the sharded union holds up to
S*C candidates and strictly DOMINATES the replicated result: a superset of
mapped reads, never a lower score, equal-score winners identical, X0/X1
counts that can only grow (slightly lower — more accurate — MAPQ on reads
with newly-retained equal hits).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.index.kmer import KmerIndex
from parasuite_tpu_torch.index.reference import PackedReference
from parasuite_tpu_torch.ops.aligner import NEG, AlignResult, align_batch
from parasuite_tpu_torch.ops.compiled import CompiledStep
from parasuite_tpu_torch.ops.device_index import DeviceIndex, ScoreParams
from parasuite_tpu_torch.parallel.dist_align import (Replicas, graph_pools,
                                                     on_device, split_reads)
from parasuite_tpu_torch.parallel.mesh import Mesh

UNMAPPED_KEY = 2 ** 30   # chromosome / position key of a shard with no hit


@dataclass
class ShardedIndex:
    """Stacked per-shard host arrays (leading axis = shard); the step
    uploads shard s to the devices of index column s."""

    ref_seq: np.ndarray        # int8  [S, G_pad]
    bucket_starts: np.ndarray  # int32 [S, 4^k + 1]
    positions: np.ndarray      # int32 [S, n_pad]
    chrom_starts: np.ndarray   # int32 [S, C_pad]  local packed starts
    chrom_ends: np.ndarray     # int32 [S, C_pad]
    orig_chrom: np.ndarray     # int32 [S, C_pad]  chrom index in the original
                               #                    (replicated) packing
    n_chroms: np.ndarray       # int32 [S]
    n_shards: int
    max_occ: int = 0           # global repeat filter baked in at build time
                               # (0 = unfiltered legacy index)

    def slabs(self, cfg: AlignConfig):
        """Validated slab tuple for make_sharded_step.

        The global repeat filter is baked in at build time, so aligning with
        a different cfg.max_occ would silently reintroduce per-shard
        divergence (a smaller align-time max_occ re-decides on per-shard
        counts; a larger one cannot resurrect emptied buckets) — fail loudly
        instead."""
        if self.max_occ and cfg.max_occ != self.max_occ:
            raise ValueError(
                f"align-time cfg.max_occ={cfg.max_occ} != build-time "
                f"max_occ={self.max_occ}; rebuild the sharded index or use "
                f"the matching config")
        return (self.ref_seq, self.bucket_starts, self.positions,
                self.chrom_starts, self.chrom_ends)

    def local_device_index(self, s: int, device="cuda") -> DeviceIndex:
        """Single-shard view (debugging), cut to the shard's own
        chromosomes."""
        c = int(self.n_chroms[s])
        return DeviceIndex.from_numpy(
            self.ref_seq[s], self.bucket_starts[s], self.positions[s],
            self.chrom_starts[s, :c], self.chrom_ends[s, :c], device)


def assign_chroms(sizes: list[int], n_shards: int) -> list[int]:
    """Greedy balanced assignment (largest first) -> shard id per chrom."""
    order = np.argsort(-np.asarray(sizes), kind="stable")
    load = np.zeros(n_shards, dtype=np.int64)
    out = [0] * len(sizes)
    for ci in order:
        s = int(np.argmin(load))
        out[int(ci)] = s
        load[s] += sizes[int(ci)]
    return out


def build_sharded_index(seqs: dict[str, np.ndarray], n_shards: int,
                        cfg: AlignConfig) -> tuple[ShardedIndex, PackedReference]:
    """Partition chromosomes across n_shards; returns (ShardedIndex, the
    ORIGINAL single packing) — the latter defines global coordinates and SAM
    emission."""
    full = PackedReference.from_dict(seqs, spacer=cfg.chrom_spacer)
    names = list(seqs.keys())
    sizes = [len(seqs[n]) for n in names]
    owner = assign_chroms(sizes, n_shards)

    refs, indexes, origs = [], [], []
    for s in range(n_shards):
        mine = {n: seqs[n] for i, n in enumerate(names) if owner[i] == s}
        if not mine:  # empty shard: minimal dummy chrom of Ns
            mine = {f"__empty{s}": np.full(1, 4, dtype=np.int8)}
            orig = [0]
        else:
            orig = [names.index(n) for n in mine]
        ref = PackedReference.from_dict(mine, spacer=cfg.chrom_spacer)
        refs.append(ref)
        indexes.append(KmerIndex.build(ref.seq, cfg.kmer_size))
        origs.append(orig)

    # Global repeat masking (VERDICT r1 #10): per-shard bucket counts sum to
    # the replicated index's count exactly (spacer Ns forbid cross-chromosome
    # k-mers), so k-mers globally over cfg.max_occ get their buckets emptied
    # in EVERY shard — the seeding filter then matches the replicated path
    # bit-for-bit instead of re-deciding on per-shard counts.
    # int32 accumulator: counts are bounded by int32 positions, and the
    # int64 transient was 8.6 GB at kmer_size=15 (ADVICE r2)
    global_cnt = np.zeros(4 ** cfg.kmer_size, dtype=np.int32)
    for ix in indexes:
        global_cnt += np.diff(ix.bucket_starts)
    keep_code = global_cnt <= cfg.max_occ
    for s, ix in enumerate(indexes):
        cnt = np.diff(ix.bucket_starts.astype(np.int64))
        new_cnt = np.where(keep_code, cnt, 0)
        new_starts = np.concatenate([[0], np.cumsum(new_cnt)]).astype(np.int32)
        indexes[s] = KmerIndex(
            k=ix.k, bucket_starts=new_starts,
            positions=ix.positions[np.repeat(keep_code, cnt)])

    g_pad = max(r.total_len for r in refs)
    n_pad = max(ix.n_kmers for ix in indexes)
    c_pad = max(len(r.names) for r in refs)
    S = n_shards
    ref_seq = np.full((S, g_pad), 4, dtype=np.int8)
    bucket_starts = np.zeros((S, indexes[0].bucket_starts.shape[0]),
                             dtype=np.int32)
    positions = np.zeros((S, max(n_pad, 1)), dtype=np.int32)
    chrom_starts = np.full((S, c_pad), np.iinfo(np.int32).max, dtype=np.int32)
    chrom_ends = np.full((S, c_pad), np.iinfo(np.int32).max, dtype=np.int32)
    orig_chrom = np.zeros((S, c_pad), dtype=np.int32)
    n_chroms = np.zeros(S, dtype=np.int32)
    for s in range(S):
        r, ix = refs[s], indexes[s]
        ref_seq[s, : r.total_len] = r.seq
        bucket_starts[s] = ix.bucket_starts
        positions[s, : ix.n_kmers] = ix.positions
        nc = len(r.names)
        chrom_starts[s, :nc] = r.starts
        chrom_ends[s, :nc] = r.ends
        orig_chrom[s, :nc] = origs[s]
        n_chroms[s] = nc
    return (ShardedIndex(ref_seq=ref_seq, bucket_starts=bucket_starts,
                         positions=positions, chrom_starts=chrom_starts,
                         chrom_ends=chrom_ends, orig_chrom=orig_chrom,
                         n_chroms=n_chroms, n_shards=S,
                         max_occ=cfg.max_occ), full)


def _shard_align(didx: DeviceIndex, orig_chrom: torch.Tensor,
                 sprof: ScoreParams, codes, lengths, min_scores,
                 cfg: AlignConfig):
    """Align against one shard and convert the winner's position to
    (original chrom index, 0-based local position)."""
    res = align_batch(didx, sprof, codes, lengths, min_scores, cfg)
    n_chrom = didx.chrom_starts.shape[0]
    ci = torch.clamp(
        torch.searchsorted(didx.chrom_starts, res.pos.contiguous(),
                           right=True) - 1, 0, n_chrom - 1)
    chrom_g = torch.where(res.mapped, orig_chrom[ci], UNMAPPED_KEY)
    local_g = torch.where(res.mapped, res.pos - didx.chrom_starts[ci], -1)
    return res, chrom_g, local_g


def merge_shard_results(parts: list, sprof: ScoreParams) -> dict:
    """Per-shard (AlignResult, chrom_g, local_g), all on sprof's device ->
    the per-read merged result in original coordinates (module docstring).
    Every reduction runs over the stacked shard axis, [S, B]."""
    def stack(get):
        return torch.stack([get(p) for p in parts])

    mapped = stack(lambda p: p[0].mapped)
    score = torch.where(mapped, stack(lambda p: p[0].score), NEG)
    strand = stack(lambda p: p[0].strand)
    chrom = stack(lambda p: p[1])
    local = stack(lambda p: p[2])
    x0 = stack(lambda p: p[0].x0)
    x1 = stack(lambda p: p[0].x1)
    ug_eq = stack(lambda p: p[0].ug_equal)
    nm = stack(lambda p: p[0].nm)
    S = mapped.shape[0]

    best_score = score.amax(dim=0)
    at_best = mapped & (score == best_score[None])
    bstrand = torch.where(at_best, strand, 2).amin(dim=0)
    at_bs = at_best & (strand == bstrand[None])
    bchrom = torch.where(at_bs, chrom, UNMAPPED_KEY).amin(dim=0)
    at_bc = at_bs & (chrom == bchrom[None])
    blocal = torch.where(at_bc, local, UNMAPPED_KEY).amin(dim=0)
    winner = at_bc & (local == blocal[None])
    # the first winning shard, 0 when none (argmax of a bool array)
    sidx = torch.arange(S, dtype=torch.int32, device=mapped.device)
    first = torch.where(winner, sidx[:, None], S).amin(dim=0)
    widx = torch.where(first == S, 0, first)

    zero = torch.zeros((), dtype=torch.int32, device=mapped.device)
    x0_g = torch.where(at_best, x0, zero).sum(dim=0, dtype=torch.int32)
    uniq_total = torch.where(mapped, x0 + x1, zero).sum(dim=0,
                                                        dtype=torch.int32)
    x1_g = uniq_total - x0_g
    mapq = torch.where(
        x0_g > 1, 0,
        torch.where(x1_g == 0, 37,
                    torch.clamp(23 - sprof.mapq_sub[
                        torch.clamp(x1_g, 0, 255).long()], min=0)))

    def pick(x):
        return x.gather(0, widx[None, :].long())[0]

    any_mapped = mapped.any(dim=0)
    return {
        "mapped": any_mapped,
        "strand": torch.where(any_mapped, pick(strand), zero),
        "chrom": torch.where(any_mapped, pick(chrom), -1),
        "local_pos": torch.where(any_mapped, pick(local), -1),
        "score": torch.where(any_mapped, best_score, NEG),
        "mapq": torch.where(any_mapped, mapq, zero).to(torch.int32),
        "x0": torch.where(any_mapped, x0_g, zero),
        "x1": torch.where(any_mapped, x1_g, zero),
        "ug_equal": torch.where(any_mapped, pick(ug_eq), True),
        "nm": torch.where(any_mapped, pick(nm), zero),
        "shard": torch.where(any_mapped, widx, -1).to(torch.int32),
    }


def _merge_flat(sprof: ScoreParams, *flat: torch.Tensor) -> dict:
    """merge_shard_results over its per-shard tuples laid out flat, each
    the AlignResult's fields, then chrom_g and local_g (the tensors of a
    CompiledStep are positional)."""
    per = len(AlignResult._fields) + 2
    parts = [(AlignResult(*flat[i:i + per - 2]), flat[i + per - 2],
              flat[i + per - 1]) for i in range(0, len(flat), per)]
    return merge_shard_results(parts, sprof)


class ShardedStep:
    """The sharded step (make_sharded_step): one CompiledStep a mesh cell
    over _shard_align, bound to the cell's slab and sprof replica, and one a
    data row over the merge, on the row's first device."""

    def __init__(self, cfg: AlignConfig, mesh: Mesh):
        self.cfg, self.mesh = cfg, mesh
        self.rows = mesh.rows()
        self._sprofs = Replicas(mesh.devices)
        self._pools = graph_pools(mesh.devices)
        # the slab tuple and its device copies, kept while the steps that
        # read them by address live
        self._held: dict = {}
        self._bound = (None, None)
        # the cells' steps [row][column] and the rows' merges: CompiledSteps,
        # or callables put in their place (the eager route: each one's .fn)
        self.cells: list = []
        self.merges: list = []

    def _grid(self, slabs, orig_chrom) -> list:
        """[row][column] (DeviceIndex, orig_chrom) of the slabs, uploaded
        once per slab tuple."""
        held = self._held
        if held.get("slabs") is not slabs[0]:
            n_index = self.mesh.shape[1]
            if slabs[0].shape[0] != n_index:
                raise ValueError(f"{slabs[0].shape[0]} index shards on a "
                                 f"mesh with {n_index} index columns")
            held["slabs"] = slabs[0]
            held["grid"] = [[
                (DeviceIndex.from_numpy(*(np.asarray(a[s]) for a in slabs),
                                        dev),
                 torch.from_numpy(np.ascontiguousarray(orig_chrom[s])
                                  ).to(dev))
                for s, dev in enumerate(row)] for row in self.rows]
        return held["grid"]

    def bind(self, slabs, orig_chrom, sprof) -> tuple[list, list]:
        """(cells, merges) over the slabs on the devices and the replicas
        of sprof, made anew when either changes object."""
        grid = self._grid(slabs, orig_chrom)
        sprofs = self._sprofs.of("sprof", sprof)
        if self._bound[0] is not grid or self._bound[1] is not sprofs:
            sp = iter(sprofs)
            self.cells = [[CompiledStep(
                functools.partial(_shard_align, didx, orig, next(sp),
                                  cfg=self.cfg),
                dev, f"shard {r},{c} {dev}", pool=self._pools[dev])
                for c, (dev, (didx, orig)) in enumerate(zip(row, shards))]
                for r, (row, shards) in enumerate(zip(self.rows, grid))]
            n_index = self.mesh.shape[1]
            self.merges = [CompiledStep(
                functools.partial(_merge_flat, sprofs[r * n_index]),
                row[0], f"merge {r} {row[0]}", pool=self._pools[row[0]])
                for r, row in enumerate(self.rows)]
            self._bound = (grid, sprofs)
        return self.cells, self.merges

    def compiled_steps(self) -> dict:
        """{name: CompiledStep} of the cells and merges bound so far."""
        return {s.name: s for s in [*sum(self.cells, []), *self.merges]
                if isinstance(s, CompiledStep)}

    def __call__(self, slabs, orig_chrom, sprof, codes, lengths,
                 min_scores) -> dict:
        cells, merges = self.bind(slabs, orig_chrom, sprof)
        reads = split_reads((codes, lengths, min_scores), self.mesh.shape[0])
        # enqueue every cell's alignment before any result is moved
        parts = []
        for row, row_cells, (c, ln, ms) in zip(self.rows, cells, reads):
            row_parts = []
            for dev, cell in zip(row, row_cells):
                with on_device(dev):
                    row_parts.append(cell(c.to(dev), ln.to(dev, torch.int32),
                                          ms.to(dev, torch.int32)))
            parts.append(row_parts)
        merged = []
        for row, row_parts, merge in zip(self.rows, parts, merges):
            first = row[0]
            with on_device(first):
                merged.append(merge(*(x.to(first) for res, cg, lg in row_parts
                                      for x in (*res, cg, lg))))
        home = self.rows[0][0]
        return {k: torch.cat([m[k].to(home) for m in merged])
                for k in merged[0]}


def make_sharded_step(cfg: AlignConfig, mesh: Mesh, data_axis: str = "data",
                      index_axis: str = "index") -> ShardedStep:
    """-> step(slabs, orig_chrom, sprof, codes, lengths, min_scores)
    returning per-read merged results in original coordinates: a dict of
    tensors in read order on the mesh's first device.

    codes/lengths/min_scores are split over the data axis, and each run goes
    to every device of its row; slab s of the ShardedIndex (slabs =
    ShardedIndex.slabs(cfg), host arrays) lives on the devices of index
    column s, uploaded once per slab tuple and kept by the step.

    Compiled, as the reference jits its shard_map: each cell's alignment and
    each row's merge is a CompiledStep (ops/compiled.py), replayed as a CUDA
    graph; the move of a row's results to its first device (the reference's
    all_gather) is a copy between devices outside the graphs. The step's
    compiled_steps() names them.
    """
    if mesh.axis_names != (data_axis, index_axis):
        raise ValueError(f"the sharded step needs a ({data_axis!r}, "
                         f"{index_axis!r}) mesh, got {mesh.axis_names}")
    return ShardedStep(cfg, mesh)
