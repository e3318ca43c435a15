from parasuite_tpu_torch.errormodel.scoring import (  # noqa: F401
    flat_score_tensor,
    profile_score_tensor,
    complement_score_tensor,
)
from parasuite_tpu_torch.errormodel.infer import (  # noqa: F401
    infer_counts_numpy,
    counts_to_profile,
    ErrorProfile,
)
