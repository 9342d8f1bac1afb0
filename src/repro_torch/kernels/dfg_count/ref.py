"""The reference's oracle for the DFG count, in plain PyTorch: the names
of ``repro.kernels.dfg_count.ref``, with its semantics — ``valid`` counts
by its integer value, a pair whose ``src`` or ``dst`` lies outside
``[0, num_activities)`` counts 0, and Ψ is int32."""

from __future__ import annotations

import torch

__all__ = ["dfg_count_ref", "dfg_count_diced_ref"]


def dfg_count_ref(src, dst, valid, *, num_activities: int) -> torch.Tensor:
    a = int(num_activities)
    src = torch.as_tensor(src)
    dst = torch.as_tensor(dst)
    v = torch.as_tensor(valid).to(torch.int32)
    # clip ids so padded/garbage rows can't index out of range (they count 0)
    s = torch.clamp(src, 0, a - 1).to(torch.int64)
    d = torch.clamp(dst, 0, a - 1).to(torch.int64)
    in_range = (src >= 0) & (src < a) & (dst >= 0) & (dst < a)
    psi = torch.zeros((a, a), dtype=torch.int32, device=src.device)
    return psi.index_put_((s, d), v * in_range.to(torch.int32), accumulate=True)


def dfg_count_diced_ref(src, dst, valid, ts_src, ts_dst, window, *,
                        num_activities: int) -> torch.Tensor:
    window = torch.as_tensor(window)
    t0, t1 = window[0], window[1]
    ts_src = torch.as_tensor(ts_src)
    ts_dst = torch.as_tensor(ts_dst)
    v = (
        torch.as_tensor(valid).to(torch.bool)
        & (ts_src >= t0) & (ts_src < t1)
        & (ts_dst >= t0) & (ts_dst < t1)
    )
    return dfg_count_ref(src, dst, v, num_activities=num_activities)
