"""The flagship's model operations: products only (convolutions, Dense
layers, the transformer block's products, the LSTMs), per example."""

from portbench import flops as fl

T, EEG_C, SPEECH_C, E, LATENT = 192, 64, 1024, 64, 8
DEPTH, EEG_K, SPEECH_K, H1, H2 = 10, 64, 32, 128, 4


def eeg_layers() -> list:
    """``(forward flops, first layer)`` of the EEG encoder per window."""
    out = [(fl.conv_flops(T, EEG_C, E, 1), True)]
    for _ in range(DEPTH):
        out += [(fl.conv_flops(T, E, E, EEG_K), False), (fl.attention_block_flops(T), False)]
    return out + [(fl.dense_flops(T, E, LATENT), False)]


def speech_layers() -> list:
    return [(fl.conv_flops(T, SPEECH_C, E, 1), True), (fl.conv_flops(T, E, E, SPEECH_K), False),
            (fl.lstm_flops(T, E, H1, 2), False), (fl.lstm_flops(T, 2 * H1, H2, 2), False)]


def head_layers(batch: int) -> list:
    """The two InfoNCE similarities, per example."""
    return [(2 * 2.0 * batch * T * LATENT, False)]


def train_flops_per_pair(batch: int) -> float:
    return fl.train_flops(eeg_layers() + speech_layers() + head_layers(batch))


def eeg_flops_per_window() -> float:
    return sum(f for f, _ in eeg_layers())
