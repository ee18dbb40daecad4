"""Rows of the UCI HIGGS schema (Baldi, Sadowski and Whiteson 2014,
"Searching for exotic particles in high-energy physics with deep
learning"), drawn on the device from a seed.

28 f32 features in the data set's order: 21 low-level (the lepton's pT,
eta and phi; the missing energy's magnitude and phi; four jets' pT, eta,
phi and b-tag) and 7 high-level masses (m_jj, m_jjj, m_lv, m_jlv, m_bb,
m_wbb, m_wwbb). Each kind of column has the normalised data set's
marginal shape: pT and the missing energy positive with a long right
tail, eta bell-shaped within the detector's +-2.4, phi uniform, b-tags
three discrete levels, masses peaked near 1 with right tails. The binary
label is a fixed function of the features plus logistic noise, about 53%
positive, as in the data set. Two calls with one seed give the same rows
on the same kind of device."""

from __future__ import annotations

import torch

FEATURES = (
    ["lepton_pT", "lepton_eta", "lepton_phi", "missing_energy_magnitude",
     "missing_energy_phi"]
    + [f"jet{j}_{k}" for j in range(1, 5) for k in ("pt", "eta", "phi", "btag")]
    + ["m_jj", "m_jjj", "m_lv", "m_jlv", "m_bb", "m_wbb", "m_wwbb"])
PT = [0, 5, 9, 13, 17]
ETA = [1, 6, 10, 14, 18]
PHI = [2, 4, 7, 11, 15, 19]
BTAG = [8, 12, 16, 20]
MET = 3
MASS_SIGMA = {21: 0.30, 22: 0.25, 23: 0.12, 24: 0.30, 25: 0.50, 26: 0.35, 27: 0.30}
BTAG_LEVELS = (0.0, 1.0868, 2.1735)
LABEL_CUT = -0.3


def make(rows: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(x (rows, 28) f32, y (rows,) f32 of 0/1) on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    z = torch.randn((rows, 28), generator=gen, device=device)
    u = torch.rand((rows, 28, 2), generator=gen, device=device).clamp_(min=1e-12)
    noise_u = torch.rand((rows,), generator=gen, device=device).clamp_(1e-7, 1 - 1e-7)
    x = torch.empty((rows, 28), dtype=torch.float32, device=device)
    gamma2 = -(u[..., 0].log() + u[..., 1].log())             # Gamma(2, 1)
    x[:, PT] = 0.27 + 0.37 * gamma2[:, PT]
    x[:, ETA] = z[:, ETA].clamp(-2.4, 2.4)
    x[:, PHI] = (u[:, PHI, 0] * 2 - 1) * 1.7412
    x[:, MET] = 0.0003 + 0.5 * gamma2[:, MET]
    b = u[:, BTAG, 0]
    x[:, BTAG] = torch.where(b < 0.55, BTAG_LEVELS[0],
                             torch.where(b < 0.75, BTAG_LEVELS[1], BTAG_LEVELS[2]))
    for j, sigma in MASS_SIGMA.items():
        x[:, j] = torch.exp(sigma * z[:, j]) * (1.0 + 0.05 * gamma2[:, j])
    return x, label(x, noise_u)


def label(x: torch.Tensor, noise_u: torch.Tensor) -> torch.Tensor:
    """The fixed function that makes the label: signal-like events have a
    heavy m_wwbb, an m_bb near the Higgs peak, hard leptons and jets,
    b-tagged jets and a correlated pair of jet masses."""
    s = (1.2 * torch.log(x[:, 27])
         - 0.9 * torch.log(x[:, 25]).abs()
         + 0.6 * (x[:, 0] - 1.0)
         + 0.4 * torch.tanh(x[:, 5] - 1.0)
         + 0.5 * (x[:, 8] > 0).float() + 0.3 * (x[:, 12] > 0).float()
         - 0.35 * x[:, 3]
         + 0.25 * torch.cos(x[:, 2] - x[:, 4])
         + 0.5 * (x[:, 21] - 1.0) * (x[:, 22] - 1.0)
         + 0.2 * x[:, 1] * x[:, 6])
    logistic = torch.log(noise_u / (1 - noise_u))
    return (s + logistic > LABEL_CUT).to(torch.float32)
