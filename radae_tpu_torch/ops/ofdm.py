"""OFDM modulation primitives on split-complex planes (port of
`radae_tpu/ops/ofdm.py`), and the streaming rx step's front end.

The Nc<->M carrier transforms are small non-power-of-2 DFT matrices applied
as pairs of real matrix products, batched over streams x symbol rows.

`rx_front_end` turns a streaming rx call's packed samples into the
decoder's latents (CP strip, DFT, LS pilot EQ, coarse magnitude, demap):
CPU tensors take the plain version `rx_front_end_plain`, a chain of torch
operations; CUDA tensors launch the hand-written kernel of
`csrc/rx_demod.cu` (one launch a call, counted in
`trace.COUNTERS["launch"]["rx_demod"]`) or raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import trace
from . import _kernels, cplx
from . import pilots as pilots_ops
from .cplx import C


def qpsk_map(z: torch.Tensor) -> C:
    """Interleaved real latents (..., L) -> QPSK symbols (..., L/2);
    even indices = I, odd = Q (reference: radae/radae.py:482)."""
    return C(z[..., ::2], z[..., 1::2])


def qpsk_demap(sym: C) -> torch.Tensor:
    """Complex symbols -> interleaved real latents (reference: radae.py:649-651)."""
    return torch.stack([sym.re, sym.im], dim=-1).reshape(
        sym.re.shape[:-1] + (2 * sym.re.shape[-1],))


def magnitude_bottleneck(x: C) -> C:
    """tanh() saturation of the complex magnitude, phase preserved, as a
    radial rescale (reference: radae.py:487,525-526)."""
    r = torch.sqrt(x.abs2() + 1e-12)
    return x * (torch.tanh(r) / r)


def insert_pilots(tx_sym: C, P: C, pilot_gain: float, Ns: int) -> C:
    """Insert one pilot row per modem frame: D...D -> PD...D.

    tx_sym: (B, T_Rs, Nc) with T_Rs divisible by Ns; P: (Nc,) pilots made
    by cplx.const.  Returns (B, T_Rs + T_Rs//Ns, Nc)
    (reference: radae.py:493-500)."""
    B, T, Nc = tx_sym.shape
    nmf = T // Ns
    framed = tx_sym.reshape(B, nmf, Ns, Nc)
    P = P * pilot_gain
    pr = P.re.expand(B, nmf, 1, Nc)
    pi = P.im.expand(B, nmf, 1, Nc)
    out = cplx.concatenate([C(pr, pi), framed], axis=2)
    return out.reshape(B, nmf * (Ns + 1), Nc)


def strip_pilots(rx_sym: C, Ns: int) -> C:
    """Drop the pilot row of each PD...D modem frame.

    rx_sym: (B, T', Nc) with T' divisible by Ns+1 -> (B, nmf, Ns, Nc)."""
    B, T, Nc = rx_sym.shape
    nmf = T // (Ns + 1)
    return rx_sym.reshape(B, nmf, Ns + 1, Nc)[:, :, 1:, :]


def idft(tx_sym: C, Winv: C) -> C:
    """Carriers -> time samples: (B, T, Nc) @ (Nc, M) -> (B, T, M)."""
    return cplx.matmul_const(tx_sym, Winv)


def dft(rx: C, Wfwd: C) -> C:
    """Time samples -> carriers: (B, T, M) @ (M, Nc) -> (B, T, Nc)."""
    return cplx.matmul_const(rx, Wfwd)


def add_cp(tx: C, Ncp: int) -> C:
    """Prefix each symbol with its last Ncp samples: (B,T,M) -> (B,T,M+Ncp)."""
    if Ncp == 0:
        return tx
    return cplx.concatenate([tx[:, :, -Ncp:], tx], axis=-1)


def strip_cp(rx: C, M: int, Ncp: int, time_offset: int = 0) -> C:
    """(B, T, M+Ncp) -> (B, T, M) sampling at Ncp+time_offset."""
    st = Ncp + time_offset
    return rx[:, :, st:st + M]


def modulate(cfg, z: torch.Tensor, P: C, Winv: C) -> torch.Tensor:
    """Latents z (B, Tz, latent_dim), Tz a whole number of modem frames ->
    packed samples (B, T, 2): QPSK map, one pilot row a modem frame, IDFT,
    CP and the PA tanh (bottleneck 3) (reference: radae.py:482-526).  P and
    Winv: cfg.P and cfg.Winv made by cplx.const."""
    B = z.shape[0]
    n_rs = z.shape[1] * cfg.latent_dim // (cfg.bps * cfg.Nc)
    with trace.span("modulate.map_pilots"):
        tx_sym = qpsk_map(z)
        if cfg.bottleneck == 2:
            tx_sym = magnitude_bottleneck(tx_sym)
        tx_sym = insert_pilots(tx_sym.reshape(B, n_rs, cfg.Nc), P,
                               cfg.pilot_gain, cfg.Ns)
    with trace.span("modulate.idft_cp"):
        tx = add_cp(idft(tx_sym, Winv), cfg.Ncp).reshape(B, -1)
    with trace.span("modulate.pa"):
        if cfg.bottleneck == 3:
            tx = magnitude_bottleneck(tx)
        return cplx.stack_last(tx)


def set_eoo_bits(cfg, eoo_bits) -> np.ndarray:
    """Embed (Ns-1)*Nc QPSK symbols worth of +/-1 bits in the EOO frame.

    Returns a new (1, Nmf+M+Ncp) complex64 EOO frame (reference:
    radae/radae.py:441-455).  Host numpy: the frame is built once and sent
    as it is."""
    Ns, Ncp, M, Nc, Nmf = cfg.Ns, cfg.Ncp, cfg.M, cfg.Nc, cfg.Nmf
    if not Ncp:
        raise ValueError("EOO data needs a cyclic prefix")
    eoo_bits = np.asarray(eoo_bits, dtype=np.float32)
    eoo_syms = (eoo_bits[::2] + 1j * eoo_bits[1::2]).reshape(1, Ns - 1, Nc)
    eoo_tx = eoo_syms @ cfg.Winv
    eoo_tx_cp = np.concatenate([eoo_tx[:, :, -Ncp:], eoo_tx], axis=-1)
    eoo_tx = eoo_tx_cp.reshape(1, (Ns - 1) * (M + Ncp)) * cfg.pilot_gain
    if cfg.bottleneck == 3:
        eoo_tx = np.tanh(np.abs(eoo_tx)) * np.exp(1j * np.angle(eoo_tx))
    eoo = cfg.eoo.copy()
    eoo[0, 2 * (M + Ncp):Nmf] = eoo_tx
    return eoo.astype(np.complex64)


# ---------------------------------------------------------------------------
# the streaming rx front end
# ---------------------------------------------------------------------------

class RxFrontEnd(NamedTuple):
    """The constants of one modem geometry's rx front end at fps frames a
    call, made once by `rx_front_end_consts` on the step's device."""
    cfg: object                  # the RADAEConfig of the modem
    fps: int
    Wfwd: C
    ls: pilots_ops.LSConsts
    pil_idx: torch.Tensor        # the pilot rows f*(Ns+1), f = 0..fps
    dat_idx: torch.Tensor        # the data rows, frame by frame
    steps: torch.Tensor          # 1..Ns, the interpolation steps
    # the kernel's constants in one f32 buffer (a CUDA device's only),
    # `_rx_kernel_consts` for the kernel's carrier lanes
    kernel: Optional[torch.Tensor]
    # the launch's geometry arguments, read from cfg once: (Ns, Nc, M, Ncp,
    # time_offset, fps, coarse_mag, mag_mul, mag_div)
    args: tuple

    @property
    def n_rs(self) -> int:
        """Symbol rows a call: fps frames and the next frame's pilot."""
        return self.fps * (self.cfg.Ns + 1) + 1


RX_TC = 4     # carriers of a lane of the kernel's DFT


def _rx_kernel_consts(cfg, cg: int) -> np.ndarray:
    """The kernel's constants for its DFT on cg lanes of RX_TC carriers
    (the library's `radae_rx_demod_lanes`): the DFT matrix, for each step
    t, carrier slot j < RX_TC and lane (kg < 32/cg, g < cg), (Wr, Wi) of
    samples 2mp and 2mp+1, mp = t*32/cg + kg, at carrier g*RX_TC + j (zero
    past M and Nc); then for each carrier 1/P, Pmat[c] (2 x 3) and
    exp(-j w a)."""
    Nc, np_, ks = cfg.Nc, cfg.M // 2, 32 // cg
    Wf = cfg.Wfwd.reshape(np_, 2, Nc)                 # mp, sample, carrier
    T = -(-np_ // ks)
    W = np.zeros((T * ks, RX_TC, cg, 2), np.complex64)  # mp, j, g, sample
    for j in range(RX_TC):
        for g in range(cg):
            if g * RX_TC + j < Nc:
                W[:np_, j, g, :] = Wf[:, :, g * RX_TC + j]
    W = W.reshape(T, ks, RX_TC, cg, 2).transpose(0, 2, 1, 3, 4)
    a = pilots_ops.LOCAL_PATH_DELAY_S * cfg.Fs
    ls = np.concatenate([
        (1.0 / cfg.P).astype(np.complex64)[:, None],
        pilots_ops.ls_pmat(cfg.w, cfg.Fs).reshape(Nc, 6),
        np.exp(-1j * cfg.w * a).astype(np.complex64)[:, None]], axis=1)
    return np.concatenate([np.ascontiguousarray(W).view(np.float32).ravel(),
                           ls.astype(np.complex64).view(np.float32).ravel()])


# the kernel's limits, by the number radae_rx_demod_limit returns
RX_DEMOD_LIMITS = {
    1: "Ns and frames_per_step at least 1, Nc at least 3, M even",
    2: "the strip point Ncp + time_offset even and within [0, Ncp], and "
       "M + Ncp even",
    3: f"Nc at most {32 * RX_TC}",
    4: "one stream's symbol rows within the card's shared memory (too "
       "many frames_per_step)",
}


def rx_front_end_consts(cfg, fps: int, device) -> RxFrontEnd:
    """The rx front end's constants for cfg's modem at fps frames a call.
    On a CUDA device also the kernel's, after checking that the kernel
    holds the geometry (raises ValueError with the limit it breaks)."""
    dev = torch.device(device)
    Ns, b3 = cfg.Ns, cfg.bottleneck == 3
    kernel = None
    if dev.type == "cuda":
        lib = _kernels.library("rx_demod")
        lim = lib.radae_rx_demod_limit(Ns, cfg.Nc, cfg.M, cfg.Ncp,
                                       cfg.time_offset, fps)
        if lim:
            raise ValueError(
                f"rx_demod: the kernel cannot hold Ns={Ns}, Nc={cfg.Nc}, "
                f"M={cfg.M}, Ncp={cfg.Ncp}, time_offset={cfg.time_offset}, "
                f"frames_per_step={fps}: it needs {RX_DEMOD_LIMITS[lim]}")
        kernel = torch.as_tensor(_rx_kernel_consts(
            cfg, lib.radae_rx_demod_lanes(cfg.Nc)), device=dev)
    return RxFrontEnd(
        cfg=cfg, fps=fps, Wfwd=cplx.const(cfg.Wfwd, dev),
        ls=pilots_ops.ls_consts(cfg.P, cfg.w, cfg.Fs, dev),
        pil_idx=torch.as_tensor([f * (Ns + 1) for f in range(fps + 1)],
                                device=dev),
        dat_idx=torch.as_tensor(np.concatenate(
            [f * (Ns + 1) + 1 + np.arange(Ns) for f in range(fps)]),
            device=dev),
        steps=torch.arange(1, Ns + 1, dtype=torch.float32,
                           device=dev)[None, None, :, None],
        kernel=kernel,
        args=(Ns, cfg.Nc, cfg.M, cfg.Ncp, cfg.time_offset, fps,
              int(cfg.coarse_mag), float(np.abs(cfg.P[0])) if b3 else 1.0,
              cfg.pilot_gain if b3 else 1.0))


def rx_front_end_plain(rx_packed: torch.Tensor, k: RxFrontEnd) -> torch.Tensor:
    """The rx front end as torch operations (the CPU's path, and the
    kernel's yardstick on the card): packed samples (B, n_rs*(M+Ncp), 2)
    -> latents (B, fps*Nzmf, latent).  Each frame is equalised from its
    own two bracketing pilot rows: the CP strip at Ncp+time_offset, the
    DFT against Wfwd, the 3-pilot LS fit of the pilot rows, the linear
    interpolation, derotation by the estimate's phase, the coarse
    magnitude (where cfg.coarse_mag), the QPSK demap.  Runs inside the
    spans `rx.front_end.dft`, `.pilot_eq` and `.demap`."""
    B = rx_packed.shape[0]
    cfg, fps = k.cfg, k.fps
    Ns, Nc = cfg.Ns, cfg.Nc
    with trace.span("rx.front_end.dft"):
        rx = cplx.from_last(rx_packed).reshape(B, k.n_rs, cfg.M + cfg.Ncp)
        rx_dash = strip_cp(rx, cfg.M, cfg.Ncp, cfg.time_offset)
        rx_sym = dft(rx_dash, k.Wfwd)                    # (B, n_rs, Nc)

    with trace.span("rx.front_end.pilot_eq"):
        rx_pilots = pilots_ops.est_pilots_ls(rx_sym[:, k.pil_idx, :], k.ls)
        p0 = rx_pilots[:, :-1, :]                        # (B, fps, Nc)
        p1 = rx_pilots[:, 1:, :]
        slope = (p1 - p0) * (1.0 / (Ns + 1))
        rx_ch = p0[:, :, None, :] + slope[:, :, None, :] * k.steps
        data = rx_sym[:, k.dat_idx, :].reshape(B, fps, Ns, Nc) \
            * rx_ch.unit().conj()
        if cfg.coarse_mag:
            # per frame, from its own two bracketing pilot rows
            p2 = 0.5 * (p0.abs2().mean(dim=-1)
                        + p1.abs2().mean(dim=-1))
            mag = torch.sqrt(p2) + 1e-6                  # (B, fps)
            if cfg.bottleneck == 3:
                mag = mag * float(np.abs(cfg.P[0])) / cfg.pilot_gain
            data = data * (1.0 / mag)[:, :, None, None]

    with trace.span("rx.front_end.demap"):
        return qpsk_demap(data.reshape(B, -1, cfg.latent_dim // 2))


def rx_front_end(rx_packed: torch.Tensor, k: RxFrontEnd) -> torch.Tensor:
    """The rx front end of a streaming rx call: packed samples (B,
    n_rs*(M+Ncp), 2) f32 -> latents (B, fps*Nzmf, latent), laid out as
    `rx_front_end_plain` gives them.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (`radae_rx_demod`, csrc/rx_demod.cu) on
    torch's current stream, once a call, and count it in
    trace.COUNTERS["launch"]["rx_demod"]."""
    dev, cfg = rx_packed.device, k.cfg
    want = (k.n_rs * (cfg.M + cfg.Ncp), 2)
    if rx_packed.dim() != 3 or tuple(rx_packed.shape[1:]) != want or \
            rx_packed.shape[0] < 1:
        raise ValueError(f"rx_front_end: expected (B, {want[0]}, 2) samples, "
                         f"got {tuple(rx_packed.shape)}")
    if dev.type == "cpu":
        return rx_front_end_plain(rx_packed, k)
    if dev.type != "cuda":
        raise ValueError(f"rx_front_end: unsupported device {dev}")
    if rx_packed.dtype != torch.float32 or k.kernel is None or \
            k.kernel.device != dev:
        raise ValueError(f"rx_front_end: expected float32 samples on the "
                         f"constants' device, got {rx_packed.dtype} on {dev}")
    x = rx_packed.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    B = x.shape[0]
    out = torch.empty((B, k.fps * cfg.Nzmf, cfg.latent_dim), device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _kernels.library("rx_demod").radae_rx_demod(
            x.data_ptr(), k.kernel.data_ptr(), out.data_ptr(), B, *k.args,
            stream)
    _kernels.check(status, "radae_rx_demod")
    trace.COUNTERS["launch"]["rx_demod"] += 1
    return out
