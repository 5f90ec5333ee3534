"""Measurement and rehearsal scripts of the port, run on the card (``python
-m transformer_clip_eeg_tpu_torch.tools.<name>``; the rehearsals also on the
CPU with ``--device cpu``)."""

import subprocess


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi reports them (every
    number a tool prints is read beside them), or ``cpu``."""
    from transformer_clip_eeg_tpu_torch.models.registry import resolve_device

    if resolve_device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def kernel_launches() -> dict:
    """This process's launches of the port's kernels, by wrapper; the bf16
    instantiations of #1 and #2 as ``<name>_bf16``."""
    from transformer_clip_eeg_tpu_torch.ops.fused_block import (
        fused_block_backward,
        fused_transformer_block,
    )
    from transformer_clip_eeg_tpu_torch.ops.fused_conv import (
        conv1d_same,
        fused_basic_block,
        fused_conv_backward,
    )
    from transformer_clip_eeg_tpu_torch.ops.lstm_scan import lstm_scan_backward, lstm_scan_packed

    counted = (fused_transformer_block, fused_block_backward, lstm_scan_packed,
               lstm_scan_backward, fused_basic_block, fused_conv_backward, conv1d_same)
    out = {f.__name__: f.launches for f in counted}
    out.update({f"{f.__name__}_bf16": f.launches_bf16
                for f in (fused_transformer_block, fused_block_backward)})
    return out
