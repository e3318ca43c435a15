"""Device-side error-profile count accumulation.

Counterpart of parasuite_tpu/ops/profile_update.py. Counts are
machine-frame: reverse-strand alignments contribute complemented reference
bases at reversed cycles. Integer adds, so the result does not depend on the
order of the adds or on how the reads were split into batches.
"""

from __future__ import annotations

import torch

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.ops.aligner import complement
from parasuite_tpu_torch.ops.device_index import DeviceIndex


def profile_counts_batch(didx: DeviceIndex, codes: torch.Tensor,
                         lengths: torch.Tensor, mapped: torch.Tensor,
                         strand: torch.Tensor, pos: torch.Tensor,
                         ug_equal: torch.Tensor,
                         cfg: AlignConfig) -> torch.Tensor:
    """-> int32 [L, 4, 4] substitution counts for this batch.

    Only ungapped-aligned reads count (gapped ones are counted on the host
    from their CIGARs)."""
    B, L = codes.shape
    G = didx.ref_seq.shape[0]
    dev = codes.device
    use = mapped & ug_equal & (lengths > 0)

    i = torch.arange(L, dtype=torch.int32, device=dev)
    # reference base under machine cycle i:
    #   fwd: ref[pos + i]; rev: comp(ref[pos + Lr - 1 - i])
    off = torch.where(strand[:, None] == 0, i[None, :],
                      torch.clamp(lengths[:, None] - 1 - i[None, :], 0, L - 1))
    ridx = pos[:, None] + off
    ok_idx = (ridx >= 0) & (ridx < G)
    rb = torch.where(ok_idx, didx.ref_seq[torch.clamp(ridx, 0, G - 1).long()]
                     .to(torch.int32), 4)
    rb = torch.where(strand[:, None] == 1, complement(rb), rb)
    cb = codes.to(torch.int32)

    valid = (use[:, None] & (i[None, :] < lengths[:, None])
             & (rb < 4) & (cb < 4))
    flat = i[None, :] * 16 + rb * 4 + cb            # cycle-major cell index
    flat = torch.where(valid, flat, L * 16)         # dropped sentinel
    # a scatter-add, not bincount: on CUDA bincount reads the input's max
    # back to the host to size its output, which would synchronise the step
    counts = torch.zeros(L * 16 + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, flat.reshape(-1).long(),
                      torch.ones(flat.numel(), dtype=torch.int32, device=dev))
    return counts[: L * 16].reshape(L, 4, 4)
