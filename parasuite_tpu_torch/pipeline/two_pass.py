"""Two-pass profile-aware alignment, library API (SURVEY.md §2 component 2,
§3.1).

Counterpart of parasuite_tpu/pipeline/two_pass.py: pass 1 aligns with the
flat tensor while accumulating the count matrix on the device, the learned
tensor is derived host-side (it is tiny), and pass 2 re-aligns with it
through the same engine. streaming_two_pass is the form the CLI's `twopass`
runs: both passes stream FASTQ -> SAM through streaming_align.

Rescued rows (config.rescue_kmer) are left out of the profile here, as in
the reference: infer_profile_streaming runs the device step without
to_host, so the rescue pass never runs in pass 1. streaming_align counts
them (ROADMAP Queue 1, "Rescued rows and the profile").
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np

from parasuite_tpu_torch.errormodel.infer import (ErrorProfile,
                                                  counts_to_profile)
from parasuite_tpu_torch.errormodel.scoring import flat_score_tensor
from parasuite_tpu_torch.io.batch import ReadBatch
from parasuite_tpu_torch.pipeline.align import AlignerEngine
from parasuite_tpu_torch.pipeline.stream import streaming_align
from parasuite_tpu_torch.utils.runlog import NULL_LOG, bind, span


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


def streaming_two_pass(engine: AlignerEngine, fastq, out, *, pass1_out,
                       profile_out, resume: bool = False, log=NULL_LOG,
                       command_line: str = "",
                       pass2_engine: Callable[[ErrorProfile], AlignerEngine]
                       | None = None) -> tuple[int, ErrorProfile, int]:
    """The CLI's `twopass`: pass 1 streams the FASTQ into pass1_out with
    the configuration's flat scores, counting the error profile (the
    device counts fused into the step, the gapped rows' CIGARs and indels
    on the host); the profile is saved to profile_out and its learned
    tensor set on the engine; pass 2 streams the FASTQ again into out.

    Pass 1 sets the flat tensor first, so that calls on one engine write
    the same bytes whatever an earlier call left set. pass2_engine, if
    given, makes pass 2's engine from the profile (the CLI's
    --learned-gaps: an engine with the learned gap penalties); else
    pass 2 reuses `engine`. On the main thread of a recording log, the
    step between the passes is the span twopass.switch.

    -> (pass 2's records, the profile, pass 1's records)."""
    engine.set_profile(flat_score_tensor(engine.cfg))
    indels: dict = {}
    n1, counts, n_profiled = streaming_align(
        engine, fastq, pass1_out, resume=resume, with_profile_counts=True,
        log=log, command_line=command_line, indel_out=indels)
    with bind(log, "main"), span("twopass.switch"):
        profile = ErrorProfile(counts=counts, n_reads=n_profiled,
                               ins_counts=indels.get("ins"),
                               del_counts=indels.get("dels"),
                               n_gapped=indels.get("n_gapped", 0))
        profile.save(profile_out)
        log.event("twopass.profile", n_reads=profile.n_reads,
                  n_gapped=profile.n_gapped)
        if pass2_engine is not None:
            engine = pass2_engine(profile)
        engine.set_profile(counts_to_profile(profile, engine.cfg))
    n, _, _ = streaming_align(engine, fastq, out, resume=resume, log=log,
                              command_line=command_line)
    return n, profile, n1
