"""DPGANSimulator — the port of ``bigdl_tpu/chronos/simulator/dpgan.py``
(ref: P:chronos/simulator/doppelganger_simulator.py — the DoppelGANger
time-series GAN with optional differential privacy).

- ``fit(series)`` trains a generator / discriminator pair of MLPs on
  windows of a (N, L, C) series batch; ``generate(n)`` samples n
  synthetic series of the same shape;
- **differential privacy**: with ``dp=True`` the discriminator's
  gradients are taken per example (``torch.func.vmap`` of
  ``torch.func.grad``), each clipped to ``dp_l2_norm`` in L2 over all
  leaves, summed, and Gaussian noise of ``dp_noise_multiplier *
  dp_l2_norm`` is added to each leaf before the mean — DP-SGD (Abadi et
  al.).

The parameters are the JAX package's lists of ``{"b", "w"}`` dicts of
tensors on ``device`` (``None``: the GPU); :meth:`load_params` carries
the JAX lists in. :meth:`train_step` takes its random draws as
arguments: the two latent batches and, with ``dp``, one noise tensor a
leaf in the tree's flatten order (each layer's ``b`` before its ``w``),
the order the JAX step splits its noise key in. ``fit`` and
``generate`` fill them from the simulator's own ``torch.Generator``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.utils.tree import tree_leaves, tree_map, \
    tree_unflatten


def _mlp_params(gen: torch.Generator, sizes) -> List[dict]:
    return [{"w": torch.randn((b, a), generator=gen) * float(
                np.sqrt(2.0 / a)),
             "b": torch.zeros(b)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _mlp(params, x, final_act=None):
    for i, p in enumerate(params):
        x = x @ p["w"].T + p["b"]
        if i < len(params) - 1:
            x = F.leaky_relu(x, 0.2)
    return final_act(x) if final_act else x


def _bce(logits, t):
    return torch.mean(torch.clamp(logits, min=0) - logits * t
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def params_from_numpy(params, device) -> List[dict]:
    """A JAX-shaped parameter list (numpy or tensors) as f32 tensors on
    ``device``."""
    return tree_map(lambda a: torch.tensor(
        np.asarray(a, np.float32)).to(device), params)


class DPGANSimulator:
    """ref API: DPGANSimulator(L_max, sample_len, ...).fit/generate."""

    def __init__(self, seq_len: int, feature_num: int = 1,
                 noise_dim: int = 16, hidden: int = 64,
                 lr: float = 1e-3, dp: bool = False,
                 dp_l2_norm: float = 1.0,
                 dp_noise_multiplier: float = 0.6, seed: int = 0,
                 device=None):
        self.seq_len = seq_len
        self.feature_num = feature_num
        self.noise_dim = noise_dim
        self.dp = dp
        self.dp_l2_norm = dp_l2_norm
        self.dp_noise = dp_noise_multiplier
        self.lr = lr
        self.device = resolve_device(device)
        out = seq_len * feature_num
        init = torch.Generator().manual_seed(seed)
        self.g_params = params_from_numpy(
            _mlp_params(init, [noise_dim, hidden, hidden, out]), self.device)
        self.d_params = params_from_numpy(
            _mlp_params(init, [out, hidden, hidden, 1]), self.device)
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._mean = 0.0
        self._std = 1.0
        self.history: list = []

    def load_params(self, g_params, d_params):
        """Carry parameter lists in (the JAX simulator's ``g_params`` /
        ``d_params`` as numpy)."""
        self.g_params = params_from_numpy(g_params, self.device)
        self.d_params = params_from_numpy(d_params, self.device)
        return self

    # -- internals -----------------------------------------------------------
    def _gen(self, params, z):
        out = _mlp(params, z, final_act=torch.tanh)
        return out.reshape(-1, self.seq_len, self.feature_num)

    def _disc_logits(self, params, x):
        return _mlp(params, x.reshape(x.shape[0], -1))[:, 0]

    def _d_loss(self, dp_, xr, xf):
        lr_ = self._disc_logits(dp_, xr)
        lf_ = self._disc_logits(dp_, xf)
        return _bce(lr_, torch.ones_like(lr_)) + \
            _bce(lf_, torch.zeros_like(lf_))

    def _d_loss_single(self, dp_, xr1, xf1):
        return self._d_loss(dp_, xr1[None], xf1[None])

    def _g_loss(self, gp_, dp_, z):
        logits = self._disc_logits(dp_, self._gen(gp_, z))
        return _bce(logits, torch.ones_like(logits))

    def _normal(self, shape, gen=None):
        return torch.randn(shape, generator=gen or self._rng,
                           device=self.device)

    # -- training ------------------------------------------------------------
    def train_step(self, xr, z, z2, noise: Optional[list] = None):
        """One discriminator and one generator step on the normalised
        batch ``xr`` (B, L, C) with the given latents ``z``, ``z2`` (B,
        noise_dim) and, with ``dp``, ``noise`` (a standard-normal tensor
        a discriminator leaf, flatten order). Returns the two losses as
        0-d tensors."""
        from torch.func import grad, grad_and_value, vmap

        gp, dpm = self.g_params, self.d_params
        xf = self._gen(gp, z)
        if self.dp:
            per_ex = vmap(grad(self._d_loss_single),
                          in_dims=(None, 0, 0))(dpm, xr, xf)
            flat = tree_leaves(per_ex)
            n = xr.shape[0]
            norms = torch.sqrt(sum(torch.sum(g.reshape(n, -1) ** 2, dim=1)
                                   for g in flat))
            clip = torch.clamp(self.dp_l2_norm
                               / torch.clamp(norms, min=1e-12), max=1.0)
            noisy = [((g * clip.reshape((-1,) + (1,) * (g.dim() - 1)))
                      .sum(dim=0) + e * (self.dp_noise * self.dp_l2_norm))
                     / n for g, e in zip(flat, noise)]
            dgrad = tree_unflatten(per_ex, noisy)
            dl = self._d_loss(dpm, xr, xf)
        else:
            dgrad, dl = grad_and_value(self._d_loss)(dpm, xr, xf)
        dpm = tree_map(lambda p, g: p - self.lr * g, dpm, dgrad)
        ggrad, gl = grad_and_value(self._g_loss)(gp, dpm, z2)
        self.g_params = tree_map(lambda p, g: p - self.lr * g, gp, ggrad)
        self.d_params = dpm
        return dl, gl

    def fit(self, series: np.ndarray, epochs: int = 50,
            batch_size: int = 64) -> "DPGANSimulator":
        x = np.asarray(series, np.float32)
        if x.ndim == 2:
            x = x[..., None]
        assert x.shape[1:] == (self.seq_len, self.feature_num), x.shape
        self._mean = float(x.mean())
        self._std = float(x.std() + 1e-8)
        xn = (x - self._mean) / (2.5 * self._std)   # keep inside tanh range

        rs = np.random.RandomState(0)
        n = len(xn)
        losses = []
        for _ in range(epochs):
            idx = rs.permutation(n)[:batch_size]
            xr = torch.from_numpy(xn[idx]).to(self.device)
            b = xr.shape[0]
            z = self._normal((b, self.noise_dim))
            z2 = self._normal((b, self.noise_dim))
            noise = [self._normal(tuple(p.shape))
                     for p in tree_leaves(self.d_params)] if self.dp \
                else None
            losses.append(torch.stack(self.train_step(xr, z, z2, noise)))
        if losses:
            self.history += [tuple(r) for r in
                             torch.stack(losses).cpu().tolist()]
        return self

    # -- sampling ------------------------------------------------------------
    def generate(self, n: int, seed: Optional[int] = None) -> np.ndarray:
        gen = None if seed is None else \
            torch.Generator(device=self.device).manual_seed(seed)
        z = self._normal((n, self.noise_dim), gen)
        with torch.no_grad():
            out = self._gen(self.g_params, z).cpu().numpy()
        return out * (2.5 * self._std) + self._mean
