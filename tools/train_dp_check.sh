#!/bin/bash
# Data-parallel training on one card against four (torchrun, NCCL) on the
# same global batch of 32: the epoch losses must agree (the trajectory does
# not depend on the world size) and the audio-sec/s show the scaling.
#     bash tools/train_dp_check.sh         (needs four cards)
#     DEV="--device cpu" bash tools/train_dp_check.sh   (Gloo on the CPU)
set -e
cd "$(dirname "$0")/.."
W=build/dp4
mkdir -p $W
python3 - <<'PY'
import numpy as np
from radae_tpu_torch.channel.doppler import multipath_samples
from radae_tpu_torch.config import flagship_config
c = flagship_config()
multipath_samples("mpp", c.Fs, c.Rs_dash, c.Nc, 30.0, G_fn="build/dp4/mpp.g", rng=np.random.default_rng(23))
x = np.fromfile("fixtures/speech_feats.f32", np.float32).reshape(-1, 36)
x[:96 * 120].tofile("build/dp4/f.f32")
PY
ARGS="--rate_Fs --pilots --pilot_eq --eq_ls --cp 0.004 --bottleneck 3 --range_EbNo --auxdata --sequence-length 120 --batch-size 32 --epochs 3 --g_file $W/mpp.g $DEV"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader || true
echo "== one process"
python3 -m radae_tpu_torch train $W/f.f32 $W/one $ARGS 2>&1 | grep epoch
echo "== four processes"
torchrun --nproc_per_node 4 --master_port 29561 -m radae_tpu_torch train $W/f.f32 $W/four $ARGS 2>&1 | grep "epoch"
