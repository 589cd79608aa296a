"""Training dataset: memory-mapped feature sequences paired with channel
sample sequences (H at rate Rs, G at rate Fs).  A numpy copy of
`radae_tpu/data/dataset.py`: the same batches from the same file and seed.

Numpy-native equivalent of the reference RADAEDataset (reference:
radae/dataset.py:36-123) producing batches ready for device upload.  H/G
files shorter than the feature file are re-used modulo, and the auxdata
symbol stream repeats each +-1 draw over 4 feature frames
(reference: dataset.py:59-64,108-123).
"""

from __future__ import annotations

import numpy as np

from .io import NB_TOTAL_FEATURES


def make_aux_symbols(num_frames: int, rng: np.random.Generator,
                     symb_repeat: int = 4) -> np.ndarray:
    """One +-1 auxdata symbol per latent step, repeated over 4 frames."""
    aux = np.zeros((num_frames, 1), dtype=np.float32)
    n_draws = -(-num_frames // symb_repeat)          # ceil
    draws = 1.0 - 2.0 * (rng.random(n_draws) > 0.5)
    for i in range(symb_repeat):
        seg = aux[i::symb_repeat, 0]
        seg[:] = draws[: len(seg)]
    return aux


class RADAEDataset:
    def __init__(self,
                 feature_file: str,
                 sequence_length: int,
                 H_sequence_length: int,
                 Nc: int,
                 G_sequence_length: int,
                 num_used_features: int = 20,
                 num_features: int = NB_TOTAL_FEATURES,
                 h_file: str = "",
                 g_file: str = "",
                 rate_Fs: bool = False,
                 auxdata: bool = False,
                 rng: np.random.Generator | None = None):
        if rng is None:
            rng = np.random.default_rng(0)
        self.sequence_length = sequence_length

        feats = np.reshape(np.fromfile(feature_file, dtype=np.float32),
                           (-1, num_features))[:, :num_used_features]
        self.num_sequences = feats.shape[0] // sequence_length
        self.rate_Fs = rate_Fs
        self.auxdata = auxdata
        if auxdata:
            feats = np.concatenate(
                [feats, make_aux_symbols(feats.shape[0], rng)], axis=1)
        self.features = feats

        self.H_sequence_length = H_sequence_length
        if h_file:
            self.H = np.reshape(np.fromfile(h_file, dtype=np.float32), (-1, Nc))
            self.H_num_sequences = self.H.shape[0] // H_sequence_length
        else:
            self.H_num_sequences = 100
            self.H = np.ones((self.H_num_sequences * H_sequence_length, Nc),
                             dtype=np.float32)

        self.G_sequence_length = G_sequence_length
        self.G_num_sequences = 0
        if g_file:
            G = np.reshape(np.fromfile(g_file, dtype=np.complex64), (-1, 2))
            mp_gain = np.real(G[0, 0])
            self.G = mp_gain * G[1:, :]
            self.G_num_sequences = self.G.shape[0] // G_sequence_length
        elif rate_Fs:
            # benign AWGN-equivalent G
            self.G_num_sequences = 100
            self.G = np.zeros((self.G_num_sequences * G_sequence_length, 2),
                              dtype=np.complex64)
            self.G[:, 0] = 1

    def __len__(self):
        return self.num_sequences

    def __getitem__(self, index):
        sl = self.sequence_length
        features = self.features[index * sl:(index + 1) * sl, :]

        h_index = index % max(self.H_num_sequences - 1, 1)
        hl = self.H_sequence_length
        H = self.H[h_index * hl:(h_index + 1) * hl, :]

        if self.G_num_sequences > 0:
            g_index = index % max(self.G_num_sequences - 1, 1)
            gl = self.G_sequence_length
            G = self.G[g_index * gl:(g_index + 1) * gl, :]
        else:
            G = np.zeros((1, 2), dtype=np.complex64)
        return features, H, G

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True, drop_last: bool = True):
        """Yield (features, H, G) numpy batches: the host-side data path.

        Auxdata symbols are re-drawn fresh for every batch.  (The reference
        draws them once at dataset construction, dataset.py:59-64; with a
        small corpus and many epochs the model then memorises the fixed
        position->bit pattern instead of learning a data channel.)"""
        order = np.arange(self.num_sequences)
        if shuffle:
            rng.shuffle(order)
        n = (self.num_sequences // batch_size) * batch_size if drop_last \
            else self.num_sequences
        for start in range(0, n, batch_size):
            idx = order[start:start + batch_size]
            if len(idx) < batch_size and drop_last:
                break
            items = [self[i] for i in idx]
            feats = np.stack([it[0] for it in items])
            if self.auxdata:
                feats = feats.copy()
                for b in range(feats.shape[0]):
                    feats[b, :, -1:] = make_aux_symbols(feats.shape[1], rng)
            yield (feats,
                   np.stack([it[1] for it in items]),
                   np.stack([it[2] for it in items]))
