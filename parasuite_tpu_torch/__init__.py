"""parasuite_tpu_torch — the PyTorch / CUDA port of parasuite_tpu.

The same aligner on tensors, with the two Pallas TPU kernels of the JAX
package (candidate select, banded extension) rewritten as CUDA C++ kernels
for Hopper (sm_90a). The JAX package stays the reference: for the same input
and AlignConfig every stage array is bit-equal and every SAM, BAM and
.errorprofile file is byte-identical.

It imports torch and never jax. The framework-free layers of the JAX
package (config, io, index, oracle, errormodel, native, utils) are imported
from it, not copied.

Layering:
    ops       -- device stages: orient, seed, select, extend, finalize,
                 profile counts; kernels in ops/cuda_*.py + csrc/*.cu
    pipeline  -- AlignerEngine, host tracebacks, streaming_align
    cli       -- index / align / twopass
"""
