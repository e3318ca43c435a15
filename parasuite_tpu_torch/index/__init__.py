from parasuite_tpu_torch.index.reference import PackedReference  # noqa: F401
from parasuite_tpu_torch.index.kmer import KmerIndex, build_index  # noqa: F401
