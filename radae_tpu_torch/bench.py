"""Headline benchmark of the port: streaming rx decode throughput on one CUDA
card, in audio-seconds/s/chip (port of the repo's bench.py).

    python -m radae_tpu_torch.bench
    BENCH_PLATFORM=cpu BENCH_BUDGET_S=45 python -m radae_tpu_torch.bench

Batches the 120 ms streaming receiver step (OFDM demod + LS pilot EQ +
stateful core decoder, `runtime.make_streaming_rx_step`) across independent
streams, on the flagship decoder with random weights from a seed
(`CoreDecoder.init(1)`, radae_tpu's draw) and unit-power noise frames.

Baseline: the reference streaming receiver decodes 9.82 s of audio in
6.41 s of CPU time (reference README.md:312-318) = 1.532 audio-seconds/s.

Robustness contract, as bench.py's:

  * The PARENT process never imports torch, so it can always flush a result.
  * The card's work happens in a CHILD process (its own session group),
    which runs LADDER cheapest first and streams one `@RUNG` line per
    completed rung; the first rung (B=8, unfused, no chain) banks a nonzero
    number in seconds.
  * If the child produces nothing within the first-result deadline, the
    parent kills the child's process group and retries ONCE with a fresh
    child restricted to the cheap rungs.
  * SIGTERM/SIGINT/SIGALRM and a watchdog thread in the parent flush the
    best result so far.

BENCH_BUDGET_S (default 360) is the whole run's budget; BENCH_PLATFORM=cpu
puts the child on the CPU (the kernels' plain versions; a test hook, whose
results never reach the cache).  Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "audio-seconds/s/chip",
   "vs_baseline": N, "config": ...}
or, when no rung completed, value 0.0 with an "error" field and the cached
last on-card result as "last_measured".
"""

import functools
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time

REF_AUDIO_SEC_PER_S = 9.82 / 6.41     # reference CPU realtime throughput
T_START = time.time()
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "360"))
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(HERE, ".bench_torch_cache.json")

# Ladder of (batch, fused, scan), cheapest first, in bench.py's order (its
# TPU grid tile has no counterpart here).  Each rung reports on completion;
# later rungs only improve the result.  fused: False = the plain layers;
# True = the unmerged decoder kernel behind the rx front end's kernel (on
# the card every rung's front end is ops/ofdm.rx_front_end's kernel);
# "int8" its int8 instance; "mergedf32" / "int8m" the chain-merged kernel
# on f32 / int8 weights.
LADDER = (
    (8,    False, 1),
    (256,  False, 8),
    (2048, "mergedf32", 256),
    (3072, "int8m", 256),
    (3072, "int8", 256),
    (3072, True,  256),
)
CHEAP_RUNGS = 2               # the retry child only runs LADDER[:CHEAP_RUNGS]
# run_bench's other modes (bench.py:115-160): "int8bf16" (int8 weights,
# bf16 products), "padf32" / "padi8" (the chain-merged kernel on the padded
# layout), "frame" / "frame_vmem" (the whole-frame kernel)
MODES = (False, True, "int8", "int8bf16", "int8m", "mergedf32", "padf32",
         "padi8", "frame", "frame_vmem")


# --------------------------------------------------------------------------
# Child: owns the card, runs the ladder, one result line per rung.
# --------------------------------------------------------------------------

def _device():
    return "cpu" if os.environ.get("BENCH_PLATFORM") == "cpu" else "cuda"


@functools.lru_cache(maxsize=1)
def _decoder_tree():
    """The flagship decoder's weights from seed 1 (numpy, never modified):
    drawn once a process, for every rung."""
    from .config import flagship_config
    from .models.core import CoreDecoder
    cfg = flagship_config()
    return CoreDecoder(cfg.latent_dim, cfg.feature_dim).init(1)


def run_bench(batch: int, n_frames: int = 5, fused=True, scan: int = 32,
              fps: int = 1, device=None) -> float:
    """Steady-state decode throughput (audio-seconds/s) by the two-point
    slope method, bench.py's.

    The serving unit of work is `scan` state-chained frames.  On the card
    they are captured once in a CUDA graph, whose replay is one device
    program (bench.py runs them as lax.scan inside jax.jit); the graph
    writes the final state back into the buffers it reads, so replays chain
    like bench.py's calls.  n1 and n2 replays are timed, each run closed by
    torch.cuda.synchronize(), and (t2 - t1) / (n2 - n1) is the time of one
    replay, the median of three.  On the CPU the chain runs eagerly.
    device: "cuda" unless BENCH_PLATFORM=cpu."""
    import numpy as np
    import torch
    from .config import flagship_config
    from .convert import params_to_torch
    from .models.core import CoreDecoder
    from .ops import fused_core as fc
    from .runtime import make_streaming_rx_step

    if fused not in MODES:
        raise ValueError(f"fused must be one of {MODES}, got {fused!r}")
    dev = torch.device(device or _device())
    cfg = flagship_config()
    decoder = CoreDecoder(cfg.latent_dim, cfg.feature_dim)
    tree = _decoder_tree()

    # The step is throughput-timed, so any well-scaled signal works: unit-
    # power noise shaped like fps modem frames + the closing pilot symbol.
    rng = np.random.default_rng(0)
    n_samp = fps * cfg.Nmf + cfg.M + cfg.Ncp
    rx = torch.as_tensor((rng.standard_normal((batch, n_samp, 2)) * 0.5)
                         .astype(np.float32), device=dev)

    if fused in ("frame", "frame_vmem"):
        # radae_tpu's rx_dma only places the TPU's sample block, in HBM
        # ("frame") or in VMEM ("frame_vmem"); the CUDA kernel stages each
        # block's samples by cp.async either way, so both run one step
        if fps != 1:
            raise ValueError("the frame step decodes one frame a call")
        step = fc.make_fused_rx_frame_step(cfg, batch, dev)
        params = fc.fused_rx_weights(tree, cfg, dev)
        mkstate = lambda: fc.decoder_state_zero(batch, dev)
    else:
        quant = ("int8" if fused in ("int8", "int8bf16", "int8m", "padi8")
                 else None)
        dtype = torch.bfloat16 if fused == "int8bf16" else None
        merged = ("pad" if fused in ("padf32", "padi8")
                  else fused in ("int8m", "mergedf32"))
        step = make_streaming_rx_step(cfg, decoder, batch, fused=bool(fused),
                                      fused_quant=quant, fused_dtype=dtype,
                                      fused_merged=merged,
                                      frames_per_step=fps, device=dev)
        if fused:
            params = fc.decoder_weights(tree, dev, merged=merged, quant=quant)
            mkstate = lambda: fc.decoder_state_zero(batch, dev, merged=merged)
        else:
            params = params_to_torch(tree, dev)
            mkstate = lambda: decoder.zero_state(batch, dev)

    def leaves(state):
        return ([state[k] for k in sorted(state)] if isinstance(state, dict)
                else list(state))

    def chain(state):
        f = None
        for _ in range(max(scan, 1)):
            f, state = step(params, rx, state)
        return f, state

    with torch.no_grad():
        if dev.type == "cuda":
            state = mkstate()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):      # warm up: builds the kernels
                chain(mkstate())
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                _, new = chain(state)
                for s, n in zip(leaves(state), leaves(new)):
                    s.copy_(n)
            zero = [s.clone() for s in leaves(mkstate())]

            def run_n(n):
                for s, z in zip(leaves(state), zero):
                    s.copy_(z)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    graph.replay()
                torch.cuda.synchronize()
                return time.perf_counter() - t0
        else:
            chain(mkstate())                   # warm up

            def run_n(n):
                state = mkstate()
                t0 = time.perf_counter()
                for _ in range(n):
                    _, state = chain(state)
                return time.perf_counter() - t0

        n1, n2 = n_frames, 5 * n_frames

        def measure():
            slopes = []
            for _ in range(3):
                t1, t2 = run_n(n1), run_n(n2)
                slopes.append((t2 - t1) / (n2 - n1))
            return float(np.median(slopes)) / (max(scan, 1) * fps)  # a frame

        # A stall during a t1 window can make a slope non-positive.  A frame
        # below 1 us is impossible for this model (one frame reads 3.6 MB of
        # weights): re-measure once, then fail the rung rather than report it.
        dt = measure()
        if dt < 1e-6:
            dt = measure()
        if dt < 1e-6:
            raise RuntimeError(f"implausible per-frame time {dt:.3e}s "
                               "(timing glitch)")
    return batch * cfg.Tmf / dt                       # B * 0.12 s a frame


def child_main(deadline: float, max_rungs: int):
    """Run the ladder; print '@RUNG {json}' per completed rung (stdout is a
    pipe to the parent, flushed per line)."""
    for batch, fused, scan in LADDER[:max_rungs]:
        if time.time() > deadline:
            break
        try:
            v = run_bench(batch, fused=fused, scan=scan)
            msg = {"value": v, "config": f"B={batch},fused={fused},scan={scan}"}
            sys.stdout.write("@RUNG " + json.dumps(msg) + "\n")
            sys.stdout.flush()
        except Exception as e:                     # a failed rung: the next
            sys.stderr.write(f"rung B={batch} failed: "
                             f"{type(e).__name__}: {e}\n")
            sys.stderr.flush()


# --------------------------------------------------------------------------
# Parent: torch-free supervisor; always emits exactly one JSON line.
# --------------------------------------------------------------------------

_best = {"value": None, "config": None, "printed": False}


def _emit(error=None):
    """Print the single JSON result line (idempotent)."""
    if _best["printed"]:
        return
    _best["printed"] = True
    if _best["value"] is None:
        out = {"metric": "streaming_rx_decode", "value": 0.0,
               "unit": "audio-seconds/s/chip", "vs_baseline": 0.0,
               "error": (error or "no config completed")[:200]}
        try:
            with open(CACHE) as f:
                # informational only: the best earlier result on the card
                # (value stays 0.0)
                out["last_measured"] = json.load(f)
        except Exception:
            pass
    else:
        out = {"metric": "streaming_rx_decode",
               "value": round(_best["value"], 1),
               "unit": "audio-seconds/s/chip",
               "vs_baseline": round(_best["value"] / REF_AUDIO_SEC_PER_S, 1),
               "config": _best["config"]}
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()


# Physical plausibility ceiling for the parent-side guard.  Decoding one
# audio-second costs ~45 MFLOP in the decoder alone (25 z-steps x 1.81 MFLOP,
# 2 per weight of its 904,064 matrix weights).  An NVIDIA H100 SXM at its
# 700 W power limit tops out at 1.5M audio-s/s in f32 outside the tensor
# cores (67 TFLOP/s) and 2.2e7 at the tensor cores' bf16 peak (989
# TFLOP/s).  Anything above the latter is a measurement artifact, not
# throughput.
PLAUSIBLE_MAX = 2.2e7


def _record(value, config):
    if not (0.0 < value < PLAUSIBLE_MAX):
        sys.stderr.write(f"discarding implausible rung value {value:.3e} "
                         f"({config})\n")
        return
    if _best["value"] is None or value > _best["value"]:
        _best["value"] = value
        _best["config"] = config
        if os.environ.get("BENCH_PLATFORM"):
            # test-hook runs (CPU) must not clobber the cached result of the
            # card that the error path reports as last_measured
            return
        try:
            # never DOWNGRADE the banked number: a deadline-cut run that only
            # reached a cheap rung keeps an earlier full-ladder result (the
            # cache is the outage fallback); every run stamps last_run
            prev = {}
            try:
                with open(CACHE) as f:
                    prev = json.load(f)
            except Exception:
                pass
            entry = {"value": round(value, 1), "config": config,
                     "unix_time": int(time.time())}
            # a copy: best must not be entry itself, which it then holds
            best = dict(entry) if value > prev.get("value", 0.0) else \
                {k: prev[k] for k in ("value", "config", "unix_time")
                 if k in prev}
            best["last_run"] = entry
            # serialize first and publish by an atomic rename, so neither an
            # exception nor a signal leaves a partial file behind
            payload = json.dumps(best)
            tmp = CACHE + ".tmp"
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, CACHE)
        except Exception:
            pass


_children = []


def _kill_children():
    for proc in _children:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except Exception:
                pass


def _on_signal(signum, frame):
    _kill_children()
    _emit(error=f"interrupted by signal {signum}")
    os._exit(0)


def _spawn_child(max_rungs: int):
    deadline = T_START + 0.92 * BUDGET_S
    proc = subprocess.Popen(
        [sys.executable, "-m", "radae_tpu_torch.bench", "--child",
         f"{deadline}", f"{max_rungs}"],
        stdout=subprocess.PIPE, stderr=sys.stderr,
        cwd=HERE, start_new_session=True, text=True)
    _children.append(proc)
    q = queue.Queue()

    def reader():
        try:
            for line in proc.stdout:
                if line.startswith("@RUNG "):
                    try:
                        q.put(json.loads(line[6:]))
                    except Exception:
                        pass
        except Exception:
            pass
        q.put(None)                                   # EOF sentinel

    threading.Thread(target=reader, daemon=True).start()
    return proc, q


def _harvest(proc, q, stop_if_no_result_by: float):
    """Drain rung results until child exit, parent budget expiry, or (while
    still resultless) the first-result deadline.  Returns True if any result
    arrived."""
    got = _best["value"] is not None
    while True:
        now = time.time()
        hard_deadline = T_START + 0.95 * BUDGET_S
        deadline = hard_deadline if got else min(hard_deadline,
                                                 stop_if_no_result_by)
        if now >= deadline:
            return got
        try:
            item = q.get(timeout=min(2.0, deadline - now))
        except queue.Empty:
            continue
        if item is None:                               # child EOF
            try:
                # never let a hung exit (or any wait error) unwind past
                # _emit: the banked result must still be printed
                proc.wait(timeout=10)
            except Exception:
                pass
            return got
        sys.stderr.write(f"rung {item['config']}: {item['value']:.1f} "
                         "audio-s/s\n")
        _record(item["value"], item["config"])
        got = True


def main():
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    if hasattr(signal, "SIGALRM"):
        signal.signal(signal.SIGALRM, _on_signal)
        signal.alarm(int(BUDGET_S))

    def watchdog():
        time.sleep(BUDGET_S + 30)
        _kill_children()
        _emit(error="watchdog: parent overran budget")
        os._exit(0)

    threading.Thread(target=watchdog, daemon=True).start()

    # Attempt 1: the full ladder; the first rung gets up to 55% of the
    # budget before the child counts as hung.
    proc, q = _spawn_child(max_rungs=len(LADDER))
    got = _harvest(proc, q, stop_if_no_result_by=T_START + 0.55 * BUDGET_S)

    if not got:
        # hung or died resultless: kill the group, retry once with a fresh
        # child on the cheap rungs only
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except Exception:
                pass
        time.sleep(2)
        proc2, q2 = _spawn_child(max_rungs=CHEAP_RUNGS)
        got = _harvest(proc2, q2,
                       stop_if_no_result_by=T_START + 0.95 * BUDGET_S)

    _kill_children()
    if hasattr(signal, "SIGALRM"):
        signal.alarm(0)
    _emit(error="the card produced no result within budget")


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == "--child":
        child_main(deadline=float(sys.argv[2]), max_rungs=int(sys.argv[3]))
    else:
        main()
