"""Operations, bytes and least times of the work a cell's calls ask for,
from the model's shapes alone (the arithmetic of `chip_smoke.py`'s
`bound()`, frozen here with the benchmark's peaks).

Peaks of one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s on the tensor
cores in bf16, 3.35 TB/s of HBM3.  An f32 product runs on the tensor cores
as bf16 parts in the port, so every matrix product is counted at the
tensor-core rate, whatever route computes it: a later f32 route on the
tensor cores cannot read above 100%.

A kernel's least time is the larger of
  * 2 FLOP a matrix weight a z-step a stream, at PEAK_FLOPS, and
  * each byte it must read or write once, at PEAK_BYTES: its weights and
    biases, the latents or features in, the outputs, the state in and out.

A call's work is a dict: `direction` "rx" (receive: the decoder) or "tx"
(send: the encoder), `streams`, and `frames` of 120 ms a stream.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
F32 = 4
FRAMES_PER_STEP = 4     # feature frames a z-step
Z_PER_FRAME = 3         # z-steps a 120 ms frame

# the core nets' widths (radae_base.py): each GRU's hidden size and the
# conv's outputs appended to the concatenated x after it, five layers
DEC_IN, DEC_GRU, DEC_CONV, DEC_LAYERS = 96, 96, 32, 5
ENC_IN, ENC_GRU, ENC_CONV, ENC_LAYERS = 64, 64, 96, 5
ENC_DILATION = (1, 2, 2, 2, 2)


def decoder_shapes(latent, features):
    """(matrix weights, bias floats, state floats a stream)."""
    mats = DEC_IN * latent
    bias = DEC_IN
    state = 0
    x = DEC_IN
    for _ in range(DEC_LAYERS):
        mats += 3 * DEC_GRU * (x + DEC_GRU)       # w_ih, w_hh
        bias += 2 * 3 * DEC_GRU
        x += DEC_GRU                              # GLU output
        mats += DEC_GRU * DEC_GRU                 # GLU gate
        mats += 2 * DEC_CONV * x                  # two taps
        bias += DEC_CONV
        state += DEC_GRU + x                      # h, conv history
        x += DEC_CONV
    out = FRAMES_PER_STEP * features
    mats += out * x
    bias += out
    return mats, bias, state


def encoder_shapes(latent, features):
    """(matrix weights, bias floats, state floats a stream)."""
    mats = ENC_IN * FRAMES_PER_STEP * features
    bias = ENC_IN
    state = 0
    x = ENC_IN
    for i in range(ENC_LAYERS):
        mats += 3 * ENC_GRU * (x + ENC_GRU)
        bias += 2 * 3 * ENC_GRU
        x += ENC_GRU
        mats += 2 * ENC_CONV * x
        bias += ENC_CONV
        state += ENC_GRU + ENC_DILATION[i] * x
        x += ENC_CONV
    mats += latent * x
    bias += latent
    return mats, bias, state


def kernel_cost(side, B, nz, latent, features):
    """(FLOP, bytes) of one launch of the decoder ("dec") or encoder ("enc")
    kernel over nz z-steps of B streams."""
    if side == "dec":
        mats, bias, state = decoder_shapes(latent, features)
        io = nz * latent + nz * FRAMES_PER_STEP * features
    elif side == "enc":
        mats, bias, state = encoder_shapes(latent, features)
        io = nz * FRAMES_PER_STEP * features + nz * latent
    else:
        raise ValueError(f"side must be dec or enc, got {side!r}")
    flops = 2.0 * mats * nz * B
    nbytes = F32 * (mats + bias + B * (io + 2 * state))
    return flops, nbytes


def least_s(flops, nbytes):
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def z_steps(work):
    """The latent steps of one call's work: 3 a 120 ms frame."""
    return Z_PER_FRAME * work["frames"]


def model_flops(work, cfg):
    """The model FLOPs of one call's work: the core net's matrix products,
    the decoder's for a receiving call, the encoder's for a sending one."""
    shapes = decoder_shapes if work["direction"] == "rx" else encoder_shapes
    mats = shapes(cfg["latent_dim"], cfg["feature_dim"])[0]
    return 2.0 * mats * z_steps(work) * work["streams"]


def frame_cost(B, cfg):
    """(FLOP, bytes) of one frame of B streams received whole: the CP
    strip, the DFT of the frame's Ns + 2 symbols (its own, its pilot row
    and the next frame's) at 8 FLOP a complex multiply-add, and the
    decoder over its 3 z-steps; each byte once: the samples in, the DFT
    matrix, the decoder's weights, features out and state in and out."""
    mats, bias, state = decoder_shapes(cfg["latent_dim"], cfg["feature_dim"])
    rows = cfg["Ns"] + 2
    nmf = (cfg["Ns"] + 1) * (cfg["M"] + cfg["Ncp"])
    samples = 2 * (nmf + cfg["M"] + cfg["Ncp"])
    dft = 8.0 * rows * cfg["M"] * cfg["Nc"]
    flops = 2.0 * mats * Z_PER_FRAME * B + dft * B
    out = Z_PER_FRAME * FRAMES_PER_STEP * cfg["feature_dim"]
    nbytes = F32 * (mats + bias + 2 * cfg["M"] * cfg["Nc"]
                    + B * (samples + out + 2 * state))
    return flops, nbytes
