"""Host milliseconds a dispatch inside the session's ``embed_eeg`` (copies,
the encoder, the readback), from the harness's proxy."""

from portbench import readers


def read(run):
    return readers.mean_ms(run["embed_spans"])
