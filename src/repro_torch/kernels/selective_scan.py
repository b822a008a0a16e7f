"""The diagonal selective scan: the wrapper of ``csrc/selective_scan.cu``
(the port of ``selective_scan_pallas``).

``selective_scan(da, dbx, h0)`` takes da, dbx (B, S, C) in bf16 or f32 and
h0 (B, C) and returns ``(h_all (B, S, C), h_last (B, C))`` in float32,
with h_t = da_t * h_{t-1} + dbx_t from h_{-1} = h0.  Any S >= 1 and C:
nothing is padded.  There is no gradient: the Pallas kernel has none and
serving needs none, so on the card the wrapper raises when an input
requires one (a training path must not drop it quietly).

A tensor on the CPU goes to the plain version ``ref.selective_scan_ref``;
a CUDA tensor launches the kernel or raises.
``selective_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import selective_scan_ref

_DTYPES = (torch.bfloat16, torch.float32)


def _check(da: torch.Tensor, dbx: torch.Tensor, h0: torch.Tensor) -> None:
    if da.dim() != 3 or dbx.shape != da.shape or min(da.shape) < 1:
        raise ValueError(f"selective_scan: want da, dbx (B, S, C) of one "
                         f"shape; got {tuple(da.shape)}, {tuple(dbx.shape)}")
    if h0.shape != (da.shape[0], da.shape[2]):
        raise ValueError(f"selective_scan: want h0 (B, C) = "
                         f"{(da.shape[0], da.shape[2])}; got "
                         f"{tuple(h0.shape)}")
    if not (da.device == dbx.device == h0.device):
        raise ValueError(f"selective_scan: inputs on {da.device}, "
                         f"{dbx.device}, {h0.device}")


def selective_scan(da: torch.Tensor, dbx: torch.Tensor,
                   h0: torch.Tensor) -> tuple:
    """The recurrence over S for every (b, c); see the module docstring."""
    _check(da, dbx, h0)
    if da.device.type == "cpu":
        return selective_scan_ref(da, dbx, h0)
    if da.device.type != "cuda" or da.device.index not in (None, 0):
        raise ValueError(f"selective_scan: no kernel for {da.device} (the "
                         f"kernels launch on cuda:0)")
    if da.dtype not in _DTYPES or dbx.dtype != da.dtype:
        raise TypeError(f"selective_scan: da and dbx must share one of "
                        f"{_DTYPES}; got {da.dtype}, {dbx.dtype}")
    if not (da.is_contiguous() and dbx.is_contiguous()):
        raise ValueError("selective_scan: da and dbx must be contiguous")
    if da.requires_grad or dbx.requires_grad or h0.requires_grad:
        raise RuntimeError("selective_scan: the kernel has no gradient; an "
                           "input requires one")
    b, s, c = da.shape
    h0 = h0.float().contiguous()
    h_all = torch.empty((b, s, c), dtype=torch.float32, device=da.device)
    h_last = torch.empty((b, c), dtype=torch.float32, device=da.device)
    lib = _build.load("selective_scan")
    err = lib.selective_scan_launch(
        da.data_ptr(), dbx.data_ptr(), h0.data_ptr(), h_all.data_ptr(),
        h_last.data_ptr(), b, s, c, int(da.dtype == torch.bfloat16),
        torch.cuda.current_stream(da.device).cuda_stream)
    _build.check_launch("selective_scan", err)
    selective_scan.launches += 1
    return h_all, h_last


selective_scan.launches = 0

__all__ = ["selective_scan", "selective_scan_ref"]
