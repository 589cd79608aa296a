from .io import (
    read_f32, write_f32, read_c64, write_c64,
    features_from_file, features_to_file,
    f32_to_int16, int16_to_f32,
    NB_TOTAL_FEATURES, NUM_USED_FEATURES,
)
from .dataset import RADAEDataset, make_aux_symbols
