"""Merge-probe payload: the port of the TPU kernel K4.

Counterpart of ``partitionedhashjoin_tpu/ops/pallas/merge_probe.py::
ranged_merge_payload_prepared``.  For each row of an ascending int32 probe
run ``b_sorted`` it finds the LOWEST position ``lb`` of its key in the
ascending int32 build run ``a_sorted`` and returns ``pos = lb + 1`` and
``pay = a_payloads[lb]`` (both 0 on a miss), so the first of a duplicate
build run wins.  On a CUDA tensor it launches the hand-written kernel in
``csrc/merge_probe.cu`` (entry ``phj_merge_probe_payload``, which shares
K1's tiling and search); on a CPU tensor it runs
``ranged_merge_payload_plain``, which tests and ``chip_smoke.py`` also hold
the kernel against.
"""

from __future__ import annotations

from typing import Tuple

import torch

from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe

#: Kernel launches since the last reset (set to 0 to reset).  Only a launch
#: of the CUDA kernel adds to it.
LAUNCHES = 0


def ranged_merge_payload_plain(
    a_sorted: torch.Tensor,
    a_payloads: torch.Tensor,
    b_sorted: torch.Tensor,
    exclude_int32_max: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: a left ``searchsorted`` into
    ``a_sorted[:limit]``, a bounds-checked compare and a gather.  Works on
    any device."""
    n_b = b_sorted.shape[0]
    zeros = torch.zeros((n_b,), dtype=torch.int32, device=b_sorted.device)
    limit = (
        merge_probe._search_limit(a_sorted, exclude_int32_max)
        if a_sorted.shape[0] and n_b else 0
    )
    if limit == 0:
        return zeros, zeros.clone()
    a = a_sorted[:limit]
    lb = torch.searchsorted(a, b_sorted, side="left")
    at = lb.clamp(max=limit - 1)
    hit = (lb < limit) & (a[at] == b_sorted)
    pos = torch.where(hit, lb + 1, 0).to(torch.int32)
    pay = torch.where(hit, a_payloads[at], 0).to(torch.int32)
    return pay, pos


def _check(a_sorted, a_payloads, b_sorted) -> None:
    for name, t in (
        ("a_sorted", a_sorted), ("a_payloads", a_payloads), ("b_sorted", b_sorted)
    ):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(
                f"{name} must be a 1-D int32 tensor, got {t.dtype} of shape "
                f"{tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != b_sorted.device:
            raise ValueError(
                f"inputs on different devices: {t.device} vs {b_sorted.device}"
            )
    if a_payloads.shape != a_sorted.shape:
        raise ValueError(
            f"a_payloads {tuple(a_payloads.shape)} does not match a_sorted "
            f"{tuple(a_sorted.shape)}"
        )
    if a_sorted.shape[0] >= 2**31 - 1:
        raise ValueError("a_sorted is too long for int32 positions")


def ranged_merge_payload_prepared(
    a_sorted: torch.Tensor,
    a_payloads: torch.Tensor,
    b_sorted: torch.Tensor,
    exclude_int32_max: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pay, pos)``, int32 tensors of ``b_sorted``'s shape: ``pos`` is 1 +
    the lowest position of the row's key in ``a_sorted`` (0 = miss), ``pay``
    the payload there (0 = miss).  ``exclude_int32_max=True`` searches only
    below the first INT32_MAX build key.  A CUDA input launches the kernel
    or raises."""
    global LAUNCHES
    _check(a_sorted, a_payloads, b_sorted)
    device = b_sorted.device
    if device.type == "cpu":
        return ranged_merge_payload_plain(
            a_sorted, a_payloads, b_sorted, exclude_int32_max
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n_a, n_b = a_sorted.shape[0], b_sorted.shape[0]
    if n_a == 0 or n_b == 0:
        zeros = torch.zeros((n_b,), dtype=torch.int32, device=device)
        return zeros, zeros.clone()
    pay = torch.empty((n_b,), dtype=torch.int32, device=device)
    pos = torch.empty((n_b,), dtype=torch.int32, device=device)
    lib = merge_probe.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.phj_merge_probe_payload(
            a_sorted.data_ptr(), a_payloads.data_ptr(), n_a,
            b_sorted.data_ptr(), n_b, int(exclude_int32_max),
            pay.data_ptr(), pos.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"phj_merge_probe_payload launch failed: CUDA error {err}"
        )
    LAUNCHES += 1
    return pay, pos
