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


def finalize_args(case: dict, device) -> tuple:
    """testing.finalize_case's arrays on `device` -> (args, kwargs) of
    ops/aligner.py::finalize_core / cuda_finalize.finalize_select. A strand
    row of the plain step is broadcast to every read (expand, row stride
    0), as aligner.finalize passes it; DeviceIndex and ScoreParams carry
    empty k-mer and score tables, which the selection never reads."""
    import torch

    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.ops.device_index import DeviceIndex, ScoreParams

    def t(name):
        return torch.from_numpy(case[name]).to(device)

    B, n = case["valid"].shape
    z32 = torch.zeros(1, dtype=torch.int32, device=device)
    didx = DeviceIndex(ref_seq=t("ref_seq"), bucket_starts=z32,
                       positions=z32, chrom_starts=t("chrom_starts"),
                       chrom_ends=t("chrom_ends"))
    sprof = ScoreParams(s_fwd=z32, s_comp=z32, mapq_sub=t("mapq_sub"))
    strand = t("strand")
    if strand.dim() == 1:
        strand = strand[None, :].expand(B, n)
    cfg = AlignConfig(max_read_len=case["oriented"].shape[2],
                      max_candidates=n // 2)
    args = (t("oriented"), t("lengths"), t("valid"), strand, t("pos_key"),
            t("dps"), t("ug_eq"), t("diag"), t("n_candidates"), didx, sprof,
            cfg)
    kwargs = {k: t(k) for k in ("src", "nm_pos", "nm_strand") if k in case}
    return args, kwargs
