"""Host milliseconds inside each ``chunk_train_step`` call (the harness's
span), averaged over the window's untraced steps."""

from portbench import readers


def read(run):
    return readers.mean_ms(run["step_spans"])
