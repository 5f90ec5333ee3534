"""``double_lstm``'s model operations: products only, per example."""

from portbench import flops as fl

T, EEG_C, SPEECH_C, SPATIAL, H, LATENT, PROJ = 192, 64, 1024, 128, 128, 8, 16


def encoder_layers(channels: int) -> list:
    return [(fl.conv_flops(T, channels, SPATIAL, 1), True),
            (fl.lstm_flops(T, SPATIAL, H, 1), False), (fl.lstm_flops(T, H, H, 1), False)]


def head_layers(batch: int) -> list:
    """Three projection heads (Dense to 16, Dense to 8) and the InfoNCE."""
    proj = fl.dense_flops(1, T * H, PROJ) + fl.dense_flops(1, PROJ, LATENT)
    return [(3 * proj, False), (2.0 * batch * LATENT, False)]


def train_flops_per_pair(batch: int) -> float:
    return fl.train_flops(encoder_layers(EEG_C) + encoder_layers(SPEECH_C) + head_layers(batch))


def eeg_flops_per_window() -> float:
    return sum(f for f, _ in encoder_layers(EEG_C))
