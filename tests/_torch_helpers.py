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


def assert_same_output(got_dir, want_dir, name):
    """File `name` written by the port's CLI (got_dir) against the JAX
    CLI's (want_dir): equal bytes. The one exception is the checkpoint
    manifest of a profile pass: the port's also carries the checkpoint's
    counts (keys "counts" and "indels", so that one rename commits them);
    it equals the JAX manifest plus those keys, and the counts equal the
    .counts.npy file both packages write."""
    import json

    import numpy as np

    got, want = (got_dir / name).read_bytes(), (want_dir / name).read_bytes()
    if not name.endswith(".progress.json"):
        assert got == want, name
        return
    got = json.loads(got)
    if "counts" in got:
        np.testing.assert_array_equal(
            got.pop("counts"),
            np.load(got_dir / name.replace(".progress.json", ".counts.npy")))
        assert got.pop("indels")["n_gapped"] >= 0
    assert got == json.loads(want), name
