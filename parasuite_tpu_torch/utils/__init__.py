from parasuite_tpu_torch.utils.dna import (  # noqa: F401
    A, C, G, T, N,
    encode_seq,
    decode_seq,
    revcomp_codes,
    complement_codes,
    BASE_TO_CODE,
    CODE_TO_BASE,
)
