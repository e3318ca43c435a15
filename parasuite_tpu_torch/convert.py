"""Carry host state of the JAX package into the port.

The port imports nothing of parasuite_tpu, so an object of that package is
never handed to it directly. These functions take what such an object holds
— its numpy arrays, lists and its dataclass dict — and build the port's own
object of the same name. On-disk state needs none of this: an index, a
config JSON or an .errorprofile written by either package loads in the other.

    import dataclasses
    cfg = convert.align_config(dataclasses.asdict(jax_cfg))
    ref = convert.packed_reference(r.seq, r.names, r.starts, r.ends)
    idx = convert.kmer_index(i.k, i.bucket_starts, i.positions)
    prof = convert.error_profile(p.counts, p.n_reads, p.ins_counts,
                                 p.del_counts, p.n_gapped)
    batch = convert.read_batch(b.codes, b.lengths, list(b.names), b.quals)
    # or, keeping a name block a name block:
    batch = convert.read_batch(b.codes, b.lengths,
                               (b.names.blob, b.names.off), b.quals)

Arrays are shared, not copied: neither package writes into them.
"""

from __future__ import annotations

import numpy as np

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.errormodel.infer import ErrorProfile
from parasuite_tpu_torch.index.kmer import KmerIndex
from parasuite_tpu_torch.index.reference import PackedReference
from parasuite_tpu_torch.io.batch import NameBlock, ReadBatch


def align_config(d: dict) -> AlignConfig:
    """AlignConfig from dataclasses.asdict() of the JAX package's (or from
    json.loads of a config JSON); an unknown field raises TypeError."""
    return AlignConfig(**d)


def packed_reference(seq, names, starts, ends) -> PackedReference:
    return PackedReference(seq=np.asarray(seq, dtype=np.int8),
                           names=list(names),
                           starts=np.asarray(starts, dtype=np.int64),
                           ends=np.asarray(ends, dtype=np.int64))


def kmer_index(k: int, bucket_starts, positions) -> KmerIndex:
    return KmerIndex(k=int(k),
                     bucket_starts=np.asarray(bucket_starts, dtype=np.int32),
                     positions=np.asarray(positions, dtype=np.int32))


def error_profile(counts, n_reads: int = 0, ins_counts=None, del_counts=None,
                  n_gapped: int = 0) -> ErrorProfile:
    def i64(a):
        return None if a is None else np.asarray(a, dtype=np.int64)

    return ErrorProfile(counts=i64(counts), n_reads=int(n_reads),
                        ins_counts=i64(ins_counts),
                        del_counts=i64(del_counts), n_gapped=int(n_gapped))


def read_batch(codes, lengths, names, quals=None) -> ReadBatch:
    """ReadBatch from its arrays; names as a list of str or as a name
    block's (blob bytes, int64 offsets) pair, quals as the uint8 matrix (or
    None for the 'I' padding)."""
    if isinstance(names, tuple):
        names = NameBlock(bytes(names[0]), np.asarray(names[1], np.int64))
    else:
        names = list(names)
    return ReadBatch(codes=np.asarray(codes, dtype=np.int8),
                     lengths=np.asarray(lengths, dtype=np.int32),
                     names=names,
                     quals=None if quals is None else np.asarray(quals))
