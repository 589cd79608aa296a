"""Primitive layers as plain functions over parameter dicts (port of
`radae_tpu/models/layers.py`: the apply functions, and the host-side
initialisers, which draw numpy arrays from a seeded numpy Generator as
radae_tpu's do, so one seed gives both packages the same weights).

Weights keep the row-major (out_features, in_features) layout of the JAX
package and of torch checkpoints, so one npz feeds both packages
(reference layer semantics: radae/radae_base.py:84-153).  Time-recurrent
layers take and return an explicit state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import draws


def quant_noise(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Simulated 8-bit quantization noise: clamp(x + U(-.5,.5)/127, -1, 1)
    (reference: radae/radae_base.py:80-81).  gen is a torch.Generator on
    x's device (or an `ops.draws.BatchRows`); it cannot reproduce
    radae_tpu's jax stream, only its distribution."""
    u = draws.rand(gen, x.shape, dtype=x.dtype) - 0.5
    return torch.clamp(x + u / 127.0, -1.0, 1.0)


def as_rng(seed) -> np.random.Generator:
    """A numpy Generator from an int seed (or the Generator itself).
    radae_tpu also takes a jax key here; the port takes seeds only."""
    if isinstance(seed, np.random.Generator):
        return seed
    if isinstance(seed, (int, np.integer)):
        return np.random.default_rng(seed)
    raise TypeError(f"init takes an int seed or a numpy Generator, got "
                    f"{type(seed).__name__}")


def _uniform(rng, shape, bound):
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _orthogonal(rng, shape):
    # orthogonal init (reference: radae_base.py:72-77)
    rows, cols = shape
    n = max(rows, cols)
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    q = q * np.sign(np.diagonal(r))
    return np.asarray(q[:rows, :cols], np.float32)


def init_dense(rng, in_dim, out_dim):
    bound = 1.0 / np.sqrt(in_dim)
    return {"w": _uniform(rng, (out_dim, in_dim), bound),
            "b": _uniform(rng, (out_dim,), bound)}


def init_gru(rng, in_dim, hidden):
    bound = 1.0 / np.sqrt(hidden)
    return {"w_ih": _uniform(rng, (3 * hidden, in_dim), bound),
            "w_hh": _orthogonal(rng, (3 * hidden, hidden)),
            "b_ih": _uniform(rng, (3 * hidden,), bound),
            "b_hh": _uniform(rng, (3 * hidden,), bound)}


def init_conv2tap(rng, in_dim, out_dim):
    bound = 1.0 / np.sqrt(in_dim * 2)
    return {"w": _uniform(rng, (out_dim, in_dim, 2), bound),
            "b": _uniform(rng, (out_dim,), bound)}


def init_glu(rng, feat):
    # gate initialised orthogonal, stored in weight-norm (g, v) form
    v = _orthogonal(rng, (feat, feat))
    return {"v": v, "g": np.linalg.norm(v, axis=1).astype(np.float32)}


def dense(params, x):
    return x @ params["w"].T + params["b"]


def gru_cell(params, x_gates, h):
    """One GRU step given precomputed input gates x_gates = x@W_ih.T + b_ih.

    Gate blocks are stacked r, z, n along the 3H axis (torch convention).
    x_gates: (..., 3H); h: (..., H).  Returns the new hidden state."""
    H = h.shape[-1]
    h_gates = h @ params["w_hh"].T + params["b_hh"]
    r = torch.sigmoid(x_gates[..., :H] + h_gates[..., :H])
    z = torch.sigmoid(x_gates[..., H:2 * H] + h_gates[..., H:2 * H])
    n = torch.tanh(x_gates[..., 2 * H:] + r * h_gates[..., 2 * H:])
    return (1.0 - z) * n + z * h


def gru(params, x, h0):
    """GRU over a sequence: x (B, T, in), h0 (B, H) -> (y (B, T, H), hT).

    The input projection is one product over all timesteps; only the
    recurrent product runs step by step."""
    x_gates = x @ params["w_ih"].T + params["b_ih"]   # (B, T, 3H)
    h = h0
    ys = []
    for t in range(x.shape[1]):
        h = gru_cell(params, x_gates[:, t], h)
        ys.append(h)
    return torch.stack(ys, dim=1), h


def conv2tap(params, x, hist, dilation=1):
    """Causal 2-tap dilated conv with tanh (reference: MyConv,
    radae_base.py:84-94).

    y[t] = tanh(W0 @ x[t-d] + W1 @ x[t] + b): w[:, :, 0] multiplies the
    delayed input x[t-d] (drawn from `hist` for t < d) and w[:, :, 1] the
    current one.  x: (B, T, in); hist: (B, d, in).  Returns (y, new_hist)."""
    d = dilation
    w0 = params["w"][:, :, 0]
    w1 = params["w"][:, :, 1]
    ext = torch.cat([hist, x], dim=1)                 # (B, d+T, in)
    x_prev = ext[:, : x.shape[1], :]                  # x[t-d]
    y = torch.tanh(x_prev @ w0.T + x @ w1.T + params["b"])
    return y, ext[:, -d:, :]


def glu_weight(params):
    """Weight-normed gate: g[:, None] * v / ||v||_row."""
    v = params["v"]
    return params["g"][:, None] * v / torch.linalg.norm(v, dim=1, keepdim=True)


def glu(params, x):
    """x * sigmoid(W x) with the weight-normed W."""
    return x * torch.sigmoid(x @ glu_weight(params).T)
