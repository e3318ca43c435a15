"""Two-pass profile-aware alignment, library API (SURVEY.md §2 component 2,
§3.1).

Counterpart of parasuite_tpu/pipeline/two_pass.py: pass 1 aligns with the
flat tensor while accumulating the count matrix on the device, the learned
tensor is derived host-side (it is tiny), and pass 2 re-aligns with it
through the same engine. The CLI's `twopass` runs the same passes through
streaming_align instead.

Rescued rows (config.rescue_kmer) are left out of the profile here, as in
the reference: infer_profile_streaming runs the device step without
to_host, so the rescue pass never runs in pass 1. streaming_align counts
them (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np

from parasuite_tpu.errormodel.infer import ErrorProfile, counts_to_profile
from parasuite_tpu.io.batch import ReadBatch
from parasuite_tpu_torch.pipeline.align import AlignerEngine


def infer_profile_streaming(engine: AlignerEngine,
                            batches: Iterable[ReadBatch]) -> ErrorProfile:
    """Pass 1: align with the current tensor, accumulate substitution counts
    on the device and indel counts from the rare gapped tracebacks on
    host."""
    L = engine.cfg.max_read_len
    total = np.zeros((L, 4, 4), dtype=np.int64)
    ins = np.zeros(L, dtype=np.int64)
    dels = np.zeros(L, dtype=np.int64)
    n_reads = 0
    n_gapped = 0
    counts_from_host = getattr(engine, "counts_from_host", False)
    for batch in batches:
        if counts_from_host:
            # combined mode: count from the emitted records — the host
            # re-finalization can re-decide the device winner
            host = engine.align_to_host(batch)
            dp, dg = engine.accumulate_profile_host(batch, host, total,
                                                    ins, dels)
            n_reads += dp
            n_gapped += dg
            continue
        res = engine.align_device(batch.codes, batch.lengths)
        counts = engine.profile_counts_device(batch.codes, batch.lengths, res)
        n_gapped += engine.gapped_indel_counts(batch, res, ins, dels,
                                               sub_counts=total)
        total += counts.cpu().numpy().astype(np.int64)
        r = res if hasattr(res, "mapped") else res[0]
        # every aligned read contributes (gapped M segments included)
        n_reads += int((r.mapped.cpu().numpy() & (batch.lengths > 0)).sum())
    return ErrorProfile(counts=total, n_reads=n_reads, ins_counts=ins,
                        del_counts=dels, n_gapped=n_gapped)


def two_pass_align(engine: AlignerEngine,
                   batch_source: Callable[[], Iterable[ReadBatch]],
                   sam_writer=None,
                   profile_path=None) -> ErrorProfile:
    """Full two-pass pipeline.

    batch_source is a zero-arg callable returning a fresh batch iterator
    (the FASTQ is streamed twice, like the reference's two alignment passes).
    Returns the inferred profile; pass-2 records go to sam_writer if given.
    """
    profile = infer_profile_streaming(engine, batch_source())
    if profile_path is not None:
        profile.save(profile_path)
    engine.set_profile(counts_to_profile(profile, engine.cfg))
    if sam_writer is not None:
        for batch in batch_source():
            host = engine.align_to_host(batch)
            engine.emit_sam(batch, host, sam_writer)
    return profile
