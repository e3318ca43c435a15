from parasuite_tpu_torch.oracle.align import (  # noqa: F401
    OracleAlignment,
    seed_candidates,
    banded_dp,
    traceback_alignment,
    align_read,
    align_batch_oracle,
)
