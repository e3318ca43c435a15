"""Mode `align`: the engine of `cli index` + `align` over the genome (flat
scores), one library call a streaming_align of the whole library, judged by
the plain reference with the configuration's flat score tensor."""

from harness import reference as plain, system

ANNOTATION = False
call = system.stream           # one streaming_align over the library


def build(conf: dict, genome: dict, txs: list, device: str):
    from parasuite_tpu_torch.config import AlignConfig
    from parasuite_tpu_torch.index import KmerIndex, PackedReference
    from parasuite_tpu_torch.pipeline.align import AlignerEngine

    cfg = AlignConfig(**conf["align"])
    ref = PackedReference.from_dict(genome, spacer=cfg.chrom_spacer)
    return AlignerEngine(ref, KmerIndex.build(ref.seq, cfg.kmer_size), cfg,
                         device=device)


def reference(genome: dict, params: dict, txs: list, tap):
    return plain.Reference(genome, params, txs)


def traced(n_batches: int) -> tuple:
    """The second half of the call's dispatches: the pipeline is full."""
    return n_batches // 2, n_batches
