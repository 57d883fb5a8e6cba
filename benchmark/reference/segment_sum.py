"""CSR segment sum of rows: the plain version of kernel K3 (frozen copy of
ed3dgs_torch/ops/segment_sum.py `segment_sum_rows_plain` and its gathered
entry), on any device.

`segment_sum_rows_plain(rows, starts, ends)` returns `out[s] =
rows[starts[s]:ends[s]].sum(0)` for monotone CSR bounds, as the difference
of float64 prefix sums rounded to float32.
"""

from __future__ import annotations

import torch


def segment_sum_rows_plain(rows: torch.Tensor, starts: torch.Tensor,
                           ends: torch.Tensor) -> torch.Tensor:
    """float64 prefix sums, differenced at the bounds, rounded to float32."""
    zero = torch.zeros((1, rows.shape[1]), dtype=torch.float64, device=rows.device)
    prefix = torch.cat([zero, torch.cumsum(rows.to(torch.float64), dim=0)])
    return (prefix[ends.long()] - prefix[starts.long()]).to(torch.float32)


def segment_sum_rows_gathered(src: torch.Tensor, idx: torch.Tensor, starts: torch.Tensor,
                              ends: torch.Tensor) -> torch.Tensor:
    """The same sums over the rows src[idx]."""
    return segment_sum_rows_plain(src[idx.long()], starts, ends)
