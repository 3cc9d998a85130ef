"""MCMC diagnostics: split R-hat and effective sample size.

Counterpart of ``friedrich_tpu/mcmc/diagnostics.py``. Standard definitions
(Gelman et al., BDA3 / Vehtari et al. 2021 split-R-hat), computed per
parameter over (num_samples, chains, dim) draws. Plain tensor functions on
whatever device the draws are on; a numpy array is taken as it is.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _as_tensor(samples) -> torch.Tensor:
    return samples if isinstance(samples, torch.Tensor) else torch.as_tensor(samples)


def split_chains(samples) -> torch.Tensor:
    """(s, c, d) -> (s//2, 2c, d): each chain split in half."""
    samples = _as_tensor(samples)
    s = samples.shape[0] - (samples.shape[0] % 2)
    return torch.cat([samples[: s // 2], samples[s // 2: s]], dim=1)


def rhat(samples) -> torch.Tensor:
    """Split-R-hat per dimension. Values near 1.0 indicate convergence."""
    x = split_chains(samples)
    s = x.shape[0]
    chain_mean = torch.mean(x, dim=0)  # (c, d)
    chain_var = torch.var(x, dim=0, correction=1)  # (c, d)
    between = s * torch.var(chain_mean, dim=0, correction=1)  # (d,)
    within = torch.mean(chain_var, dim=0)  # (d,)
    var_est = (s - 1) / s * within + between / s
    return torch.sqrt(var_est / within)


def _autocovariance_fft(xc: torch.Tensor) -> torch.Tensor:
    """Biased (/s) per-chain autocovariance at every lag, via FFT.

    ``xc``: (s, c, d) chain-mean-centered draws. Returns (s, c, d). Zero
    padding to a power of two at least 2s avoids circular wrap-around, so
    the Geyer stopping rule sees every lag."""
    s = xc.shape[0]
    nfft = 1
    while nfft < 2 * s:
        nfft *= 2
    f = torch.fft.rfft(xc, n=nfft, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=0)[:s]
    return acov / s


def ess(samples, max_lag: Optional[int] = None) -> torch.Tensor:
    """Bulk effective sample size per dimension (Vehtari et al. 2021:
    combined-chain correlations via var+; Geyer initial positive sequence
    with the initial monotone refinement, adaptively stopped).

    ``max_lag``: optional cap on the number of lags considered (default:
    all ``s - 1``). Between-chain disagreement enters through ``var_plus``,
    so unmixed chains collapse the ESS instead of inflating it.
    """
    x = split_chains(samples)
    s, c, _ = x.shape
    chain_mean = torch.mean(x, dim=0, keepdim=True)
    xc = x - chain_mean
    w = torch.mean(torch.var(x, dim=0, correction=1), dim=0)  # (d,)
    b = s * torch.var(chain_mean[0], dim=0, correction=1)  # (d,)
    var_plus = (s - 1) / s * w + b / s
    n_lag = s - 1 if max_lag is None else min(max_lag, s - 1)

    acov = torch.mean(_autocovariance_fft(xc), dim=1)[:n_lag]  # (n_lag, d)
    rho = 1.0 - (w[None, :] - acov) / torch.clamp(var_plus[None, :], min=1e-30)
    # Geyer initial positive sequence: pair sums P_k = rho_2k + rho_2k+1,
    # truncated at the first non-positive pair ...
    m = (n_lag // 2) * 2
    pair = rho[0:m:2] + rho[1:m:2]  # (m/2, d)
    pos = torch.cumprod((pair > 0).to(rho.dtype), dim=0)
    # ... and each surviving pair replaced by the running minimum (the
    # initial monotone refinement)
    mono = torch.cummin(torch.where(pos > 0, pair, torch.inf), dim=0).values
    tau = 2.0 * torch.sum(torch.where(pos > 0, mono, 0.0), dim=0) - 1.0
    tau = torch.clamp(tau, min=1e-3)
    # a degenerate tau must not report millions of effective draws: cap
    # like Stan
    cap_val = s * c * math.log10(max(float(s * c), 10.0))
    return torch.clamp(s * c / tau, max=cap_val)


def summary(samples) -> dict:
    """Posterior summary dict (mean, std, R-hat, ESS) per dimension."""
    samples = _as_tensor(samples)
    return {
        "mean": torch.mean(samples, dim=(0, 1)),
        "std": torch.std(samples, dim=(0, 1), correction=0),
        "rhat": rhat(samples),
        "ess": ess(samples),
    }
