"""Log-domain Sinkhorn optimal transport (the 'sinkhorn' coarse matcher).

Counterpart of geoformer_tpu/ops/sinkhorn.py: a dustbin row and column
filled with a learned bin score, a fixed number of iterations, and the
log-coupling scaled by M + N (``Z - norm``). Everything runs in the
scores' dtype, as in the JAX package.
"""

from __future__ import annotations

import torch


def log_sinkhorn(Z: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """Sinkhorn normalization in log space. Z: [B, M, N]; log_mu [B, M],
    log_nu [B, N]."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(Z + u[:, :, None], dim=1)
    return Z + u[:, :, None] + v[:, None, :]


def log_optimal_transport(scores: torch.Tensor, bin_score: torch.Tensor,
                          iters: int = 3) -> torch.Tensor:
    """scores [B, M, N] -> [B, M+1, N+1] log-coupling with dustbins,
    multiplied by M + N as in the reference."""
    b, m, n = scores.shape
    dt, dev = scores.dtype, scores.device
    ms = torch.tensor(float(m), dtype=dt, device=dev)
    ns = torch.tensor(float(n), dtype=dt, device=dev)
    alpha = bin_score.to(dt).reshape(1, 1, 1)
    couplings = torch.cat([
        torch.cat([scores, alpha.expand(b, m, 1)], -1),
        torch.cat([alpha.expand(b, 1, n), alpha.expand(b, 1, 1)], -1)], 1)
    norm = -torch.log(ms + ns)
    log_mu = torch.cat([norm.expand(m), (torch.log(ns) + norm)[None]])
    log_nu = torch.cat([norm.expand(n), (torch.log(ms) + norm)[None]])
    Z = log_sinkhorn(couplings, log_mu[None].expand(b, m + 1),
                     log_nu[None].expand(b, n + 1), iters)
    return Z - norm
