"""What the tests/test_torch_*.py files share. Imports neither package at
module level, so the card tests can use it on a machine without JAX."""

import dataclasses


def to_port(obj):
    """A host object of the JAX package as the port's own, through
    convert.py (arrays and dicts cross, never the object): what every
    tests/test_torch_*.py file hands to the port."""
    from parasuite_tpu_torch import convert

    assert type(obj).__module__.split(".")[0] == "parasuite_tpu", type(obj)
    kind = type(obj).__name__
    if kind == "AlignConfig":
        return convert.align_config(dataclasses.asdict(obj))
    if kind == "PackedReference":
        return convert.packed_reference(obj.seq, obj.names, obj.starts,
                                        obj.ends)
    if kind == "KmerIndex":
        return convert.kmer_index(obj.k, obj.bucket_starts, obj.positions)
    if kind == "ErrorProfile":
        return convert.error_profile(obj.counts, obj.n_reads, obj.ins_counts,
                                     obj.del_counts, obj.n_gapped)
    if kind == "ReadBatch":
        names = obj.names
        if hasattr(names, "blob"):
            names = (names.blob, names.off)
        return convert.read_batch(obj.codes, obj.lengths, names, obj.quals)
    raise TypeError(f"no conversion for {type(obj)}")
