"""parasuite_tpu_torch — the PyTorch / CUDA port of parasuite_tpu.

The same aligner on tensors, with the two Pallas TPU kernels of the JAX
package (candidate select, banded extension) rewritten as CUDA C++ kernels
for Hopper (sm_90a). The JAX package stays the reference: for the same input
and AlignConfig every stage array is bit-equal and every SAM, BAM and
.errorprofile file is byte-identical.

It imports torch, never jax and nothing of parasuite_tpu: the host layers
(config, io, index, oracle, errormodel, native, utils) are its own copies
under the same names, and convert.py turns the JAX package's host objects,
handed over as numpy arrays and dicts, into the port's.

Layering:
    config, utils, io, index, native, oracle, errormodel
              -- host layers, copies of the JAX package's (same files and
                 on-disk formats; native/ builds its own C++ library)
    ops       -- device stages: orient, seed, select, extend, finalize,
                 candidate table, profile counts; kernels in
                 ops/cuda_*.py + csrc/*.cu
    pipeline  -- AlignerEngine (XA tags, two-tier rescue), host tracebacks,
                 streaming_align, the two-pass API, CombinedEngine
                 (genome+transcriptome)
    sim       -- repeat-structured synthetic genomes, the read simulator
    benchkit  -- accuracy against simulation truth, throughput timer
    cli       -- index / combine / align / twopass / simulate / benchmark /
                 cluster / sort / convert
"""

__version__ = "0.1.0"    # written into @PG; equal to the JAX package's
