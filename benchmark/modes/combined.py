"""Mode `combined`: the engine of `combine` + a combined `align` over the
genome and its spliced transcripts (flat scores), one library call a
streaming_align of the whole library, judged by the plain reference over
the same combined packing with the configuration's flat score tensor."""

from harness import reference as plain, system

ANNOTATION = True
call = system.stream           # one streaming_align over the library


def build(conf: dict, genome: dict, txs: list, device: str):
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.index import KmerIndex
    from parasuite_tpu_torch.pipeline.combined import (CombinedEngine,
                                                       CombinedReference,
                                                       Transcript)

    cfg = AlignConfig(**conf["align"])
    comb = CombinedReference.build(
        genome, [Transcript(t.tx_id, t.chrom, t.strand, t.exon_starts,
                            t.exon_ends) for t in txs],
        spacer=cfg.chrom_spacer)
    return CombinedEngine(comb, KmerIndex.build(comb.ref.seq, cfg.kmer_size),
                          cfg, device=device)


def reference(genome: dict, params: dict, txs: list, tap):
    return plain.Reference(genome, params, txs)


def traced(n_batches: int) -> tuple:
    """The second half of the call's dispatches: the pipeline is full."""
    return n_batches // 2, n_batches
