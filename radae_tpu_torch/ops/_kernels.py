"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` at first use into `build/` at the root of
the checkout, as a shared library with a plain C interface, and bound with
ctypes.  Nothing is built or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

from .. import trace

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "radae_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of each library's entries: name -> argtypes (restype int).
# Every launch entry takes (weights, offsets, n_off, [kinds, scale offsets,
# n_scales,] input, output, <sizes>, state_in[], state_out[], stream) and
# returns the launch's cudaError_t (the bracketed three: all but the f32
# frame entry; the mma entries, the merged decoder's x entry and the
# frame's bf16 entry also take the packed buffer and its offsets,
# `mma_weights`, after the sizes and their flags);
# the entries with no arguments return a constant of the
# kernels' tiling, and radae_rx_frame_limit the frame kernel's limit a
# modem geometry breaks.  rx_demod (the streaming rx front end): its
# launch entry takes (samples, constants, latents, B, Ns, Nc, M, Ncp,
# time_offset, fps, coarse_mag, mag_mul, mag_div, stream),
# radae_rx_demod_limit the geometry and returns the limit it breaks, and
# radae_rx_demod_lanes Nc and returns the kernel's DFT lanes across it.
_SIGNATURES = {
    "fused_core": {
        "radae_block_rows": [],
        "radae_enc_tile_rows": [],
        "radae_dec_tile_rows": [],
        "radae_fused_decoder_step": [_P, _P, _I, _P, _P, _I, _P, _P, _I, _I,
                                     _I, _I, _P, _P, _P],
        "radae_fused_decoder_mma_step": [_P, _P, _I, _P, _P, _I, _P, _P, _I,
                                         _I, _I, _I, _I, _P, _P, _P, _P, _P],
        "radae_fused_decoder_merged_step": [_P, _P, _I, _P, _P, _I, _P, _P,
                                            _I, _I, _I, _I, _P, _P, _P],
        "radae_fused_decoder_merged_x_step": [_P, _P, _I, _P, _P, _I, _P, _P,
                                              _I, _I, _I, _I, _I, _I, _P, _P,
                                              _P, _P, _P],
        "radae_rx_frame_limit": [_I, _I, _I, _I, _I],
        "radae_fused_rx_frame_step": [_P, _P, _I, _P, _P, _I, _I, _F, _I,
                                      _I, _I, _I, _I, _I, _P, _P, _P],
        "radae_fused_rx_frame_bf16_step": [_P, _P, _I, _P, _P, _I, _P, _P,
                                           _I, _I, _F, _I, _I, _I, _I, _I,
                                           _I, _P, _P, _P, _P, _P],
        "radae_fused_encoder_step": [_P, _P, _I, _P, _P, _I, _P, _P, _I, _I,
                                     _I, _I, _I, _P, _P, _P],
        "radae_fused_encoder_mma_step": [_P, _P, _I, _P, _P, _I, _P, _P, _I,
                                         _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                         _P],
    },
    "rx_demod": {
        "radae_rx_demod_limit": [_I] * 6,
        "radae_rx_demod_lanes": [_I],
        "radae_rx_demod": [_P, _P, _P] + [_I] * 8 + [_F, _F, _P],
    },
}

_loaded: dict = {}
_build_t0: dict = {}    # library name -> perf_counter at its nvcc's start


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def start_build(name: str):
    """Start nvcc for one source (no-op when the library is up to date);
    returns the Popen or None.  Several can run at once.  Each run counts
    in trace.COUNTERS["build"][name], its seconds (at finish_build) under
    name + "_s"."""
    src, lib = SRC_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so"
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = open(BUILD_DIR / f"{name}.log", "w")
    try:
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(lib),
                                 str(src)], stdout=log,
                                stderr=subprocess.STDOUT)
    finally:
        log.close()
    trace.count("build", name)
    _build_t0[name] = time.perf_counter()
    return proc


def finish_build(name: str, proc) -> str:
    """Wait for a build started by start_build; returns the compiler log."""
    if proc is not None:
        rc = proc.wait()
        trace.count("build", f"{name}_s",
                    time.perf_counter() - _build_t0.pop(name))
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                               + (BUILD_DIR / f"{name}.log").read_text())
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The bound library `name`, built first if needed (a load counts in
    trace.COUNTERS["load"])."""
    if name not in _loaded:
        finish_build(name, start_build(name))
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
        trace.count("load", name)
    return _loaded[name]


def check(status: int, what: str):
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{status}")
