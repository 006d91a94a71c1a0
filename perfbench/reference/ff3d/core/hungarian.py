"""Linear assignment for Hungarian matching.

Port of ``focalformer3d_tpu/core/hungarian.py`` with its two methods:

* ``auction``: the forward auction (persons = GT columns, objects = query
  rows) from zero prices with one epsilon, as the JAX ``auction_assign``.
  JAX vmaps a per-problem ``while_loop``; here every (sample, round)
  problem of a batch runs in one loop of batched tensor ops, each problem
  with its own iteration counter capped at ``max_iters`` and frozen once it
  has converged, which gives each problem the JAX result. One host sync per
  iteration only decides when every problem is done.
* ``scipy``: exact Jonker-Volgenant on the host (``linear_sum_assignment``),
  for parity checks.

Both take padded cost matrices (..., Q, G) and validity masks and return
per row (query) the matched column (GT) or -1, plus the auction's
iteration count.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

BIG_COST = 1e6


def _auction(benefit: torch.Tensor, col_valid: torch.Tensor,
             eps: torch.Tensor, max_iters: int
             ) -> Tuple[torch.Tensor, int]:
    """Forward auction on (N, G, Q) benefits; returns (person_obj (N, G):
    the object each person holds or -1, loop iterations run)."""
    N, G, Q = benefit.shape
    dev = benefit.device
    person_obj = torch.full((N, G), -1, dtype=torch.int64, device=dev)
    owner = torch.full((N, Q), -1, dtype=torch.int64, device=dev)
    price = torch.zeros((N, Q), dtype=benefit.dtype, device=dev)
    it = torch.zeros(N, dtype=torch.int64, device=dev)
    n_idx = torch.arange(N, device=dev)[:, None]
    g_idx = torch.arange(G, device=dev)
    q_idx = torch.arange(Q, device=dev)
    neg_inf = torch.tensor(-float("inf"), dtype=benefit.dtype, device=dev)
    steps = 0
    while True:
        unassigned = (person_obj < 0) & col_valid  # (N, G)
        active = unassigned.any(1) & (it < max_iters)  # (N,)
        if not bool(active.any()):
            return person_obj, steps
        steps += 1
        values = benefit - price[:, None, :]
        v1, i1 = values.max(-1)  # first maximum, as jnp.argmax
        values2 = values.clone()
        values2[n_idx, g_idx[None], i1] = neg_inf
        v2 = values2.max(-1).values
        bid_price = torch.gather(price, 1, i1) + (v1 - v2) + eps[:, None]
        bidding = (q_idx[None, None] == i1[..., None]) & unassigned[..., None]
        bids = torch.where(bidding, bid_price[..., None], neg_inf)
        win_val, win_person = bids.max(1)  # (N, Q)
        has_bid = torch.isfinite(win_val) & (win_val > neg_inf)
        new_owner = torch.where(has_bid, win_person, owner)
        evicted = (owner != new_owner) & (owner >= 0)
        new_po = person_obj.clone()
        rows = n_idx.expand(N, Q)
        new_po[rows[evicted], owner[evicted]] = -1
        new_po[rows[has_bid], new_owner[has_bid]] = q_idx.expand(N, Q)[has_bid]
        new_price = torch.where(has_bid, win_val, price)
        a = active[:, None]
        person_obj = torch.where(a, new_po, person_obj)
        owner = torch.where(a, new_owner, owner)
        price = torch.where(a, new_price, price)
        it = it + active.to(torch.int64)


def auction_assign(cost: torch.Tensor, row_valid: torch.Tensor,
                   col_valid: torch.Tensor, eps_frac: float = 2e-4,
                   max_iters: int = 8192) -> Tuple[torch.Tensor, int]:
    """Batched auction. cost (..., Q, G); row_valid (..., Q); col_valid
    (..., G). Returns (row_to_col (..., Q) int32 with -1 unmatched, loop
    iterations run). From zero prices the assignment is within G*eps of
    optimal, eps = eps_frac * max |benefit| of the valid columns."""
    lead, (Q, G) = cost.shape[:-2], cost.shape[-2:]
    cost = cost.reshape(-1, Q, G)
    row_valid = row_valid.reshape(-1, Q)
    col_valid = col_valid.reshape(-1, G)
    N = cost.shape[0]
    cost = torch.where(row_valid[:, :, None], cost, BIG_COST)
    benefit = -cost.transpose(1, 2)  # (N, G, Q)
    scale = torch.clamp(torch.where(col_valid[:, :, None], benefit, 0.0)
                        .abs().amax((1, 2)), min=1e-3)
    person_obj, steps = _auction(benefit, col_valid, scale * eps_frac,
                                 max_iters)
    row_to_col = torch.full((N, Q + 1), -1, dtype=torch.int32,
                            device=cost.device)
    tgt = torch.where((person_obj >= 0) & col_valid, person_obj, Q)
    gt_ids = torch.arange(G, dtype=torch.int32, device=cost.device)
    row_to_col.scatter_(1, tgt, torch.where(col_valid, gt_ids, -1))
    return row_to_col[:, :Q].reshape(*lead, Q), steps


def scipy_assign(cost: torch.Tensor, row_valid: torch.Tensor,
                 col_valid: torch.Tensor) -> torch.Tensor:
    """Exact assignment of each (Q, G) problem on the host; the interface of
    ``auction_assign`` without the iteration count."""
    from scipy.optimize import linear_sum_assignment

    lead, (Q, G) = cost.shape[:-2], cost.shape[-2:]
    cost = torch.where(row_valid[..., :, None], cost, BIG_COST)
    cost = torch.where(col_valid[..., None, :], cost, BIG_COST)
    mats = cost.detach().reshape(-1, Q, G).cpu().double().numpy()
    out = np.full((mats.shape[0], Q), -1, np.int64)
    for i, m in enumerate(mats):
        rows, cols = linear_sum_assignment(m)
        out[i, rows] = cols
    r2c = torch.from_numpy(out).to(cost.device).reshape(*lead, Q)
    matched = torch.gather(col_valid, -1, r2c.clamp(0, G - 1)) & (r2c >= 0)
    return torch.where(matched, r2c, -1).to(torch.int32)


def assign(cost, row_valid, col_valid, method: str = "auction"
           ) -> Tuple[torch.Tensor, int]:
    """(row_to_col, auction iterations (0 for scipy))."""
    if method == "auction":
        return auction_assign(cost, row_valid, col_valid)
    if method == "scipy":
        return scipy_assign(cost, row_valid, col_valid), 0
    raise ValueError(method)
