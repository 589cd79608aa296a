"""Split-complex arithmetic: complex tensors as (re, im) float32 planes.

The port keeps the JAX package's split-complex representation
(`radae_tpu/ops/cplx.py`) at its public functions instead of switching to
torch.complex64.  Two reasons:

  * parity: every complex product, DFT and phase rotation runs the same
    real float32 operations in the same order as the reference, so the
    CPU tests agree with JAX at float32 tolerances;
  * interface: the serving steps take and return packed (..., 2) float IQ
    and the kernels take float planes, so no complex dtype crosses a
    boundary.

The Nc<->M DFTs are pairs of real matrix products; phase rotations use
conj-multiply normalisation instead of angle/exp.  Host constants (numpy
complex arrays) are split into device planes once with `const`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class C(NamedTuple):
    """A complex tensor as two same-shape float planes."""
    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape

    def reshape(self, *shape):
        return C(self.re.reshape(*shape), self.im.reshape(*shape))

    def __getitem__(self, idx):
        return C(self.re[idx], self.im[idx])

    def conj(self):
        return C(self.re, -self.im)

    def __add__(self, o):
        if isinstance(o, C):
            return C(self.re + o.re, self.im + o.im)
        return C(self.re + o, self.im)

    def __sub__(self, o):
        if isinstance(o, C):
            return C(self.re - o.re, self.im - o.im)
        return C(self.re - o, self.im)

    def __mul__(self, o):
        if isinstance(o, C):
            return C(self.re * o.re - self.im * o.im,
                     self.re * o.im + self.im * o.re)
        return C(self.re * o, self.im * o)   # real scalar/tensor

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, C):
            d = o.re * o.re + o.im * o.im
            return C((self.re * o.re + self.im * o.im) / d,
                     (self.im * o.re - self.re * o.im) / d)
        return C(self.re / o, self.im / o)

    def abs2(self):
        return self.re * self.re + self.im * self.im

    def abs(self):
        return torch.sqrt(self.abs2())

    def unit(self, eps=1e-12):
        """self / |self| — the phase factor, without computing the angle."""
        r = torch.sqrt(self.abs2() + eps)
        return C(self.re / r, self.im / r)


def const(z_np: np.ndarray, device) -> C:
    """Host complex numpy constant -> float32 planes on `device`."""
    z_np = np.asarray(z_np)

    def plane(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    return C(plane(z_np.real), plane(z_np.imag))


def zeros(shape, device) -> C:
    return C(torch.zeros(shape, device=device),
             torch.zeros(shape, device=device))


def expj(theta: torch.Tensor) -> C:
    """e^{j theta} for a real tensor theta."""
    return C(torch.cos(theta), torch.sin(theta))


def matmul_const(a: C, w: C) -> C:
    """a @ W, W a constant made by `const`: four real matrix products."""
    return C(a.re @ w.re - a.im @ w.im, a.re @ w.im + a.im @ w.re)


def mul_const(a: C, z: C) -> C:
    """a * z, z a constant made by `const` (broadcast over a)."""
    return a * z


def concatenate(parts, axis=0) -> C:
    return C(torch.cat([p.re for p in parts], axis),
             torch.cat([p.im for p in parts], axis))


def stack_last(x: C) -> torch.Tensor:
    """Pack to an interleaved (..., 2) float tensor."""
    return torch.stack([x.re, x.im], dim=-1)


def from_last(x: torch.Tensor) -> C:
    """Unpack an interleaved (..., 2) float tensor."""
    return C(x[..., 0], x[..., 1])


def from_c64(x: np.ndarray, device) -> torch.Tensor:
    """Host complex64 samples (...,) -> an interleaved (..., 2) float32
    tensor on `device` (one host-to-device copy; on the CPU a copy too, so
    the tensor never shares a caller's, maybe read-only, buffer)."""
    x = np.array(x, np.complex64)
    return torch.as_tensor(x.view(np.float32).reshape(x.shape + (2,)),
                           device=device)


def pack_np(x: np.ndarray) -> np.ndarray:
    """Host complex64 (...,) -> an interleaved (..., 2) float32 array."""
    x = np.ascontiguousarray(x, dtype=np.complex64)
    return x.view(np.float32).reshape(x.shape + (2,))


def to_c64(x: torch.Tensor) -> np.ndarray:
    """An interleaved (..., 2) float tensor -> host complex64 (...,) (one
    device-to-host copy)."""
    x = np.ascontiguousarray(x.detach().cpu().numpy(), np.float32)
    return x.view(np.complex64).reshape(x.shape[:-1])
