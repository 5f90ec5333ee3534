"""The frozen counts against the port's performance record (PERF.md's kernel
table: bounds at 67 TFLOP/s and 3.35 TB/s) and the configurations' totals."""

import pytest

from portbench import flops as fl
from portbench.configs import double_lstm_flops, flagship_flops

RECORD_PEAK = 67e12  # the record's float32 peak outside the tensor cores


def record_ms(flops, nbytes):
    return max(flops / RECORD_PEAK, nbytes / fl.PEAK_BYTES) * 1e3


def test_block_counts():
    assert fl.block_fwd_flops(128, 192) == pytest.approx(3.62e9, rel=2e-3)
    assert fl.block_bwd_flops(128, 192) == pytest.approx(7.25e9, rel=2e-3)
    assert record_ms(fl.block_fwd_flops(128, 192), fl.block_fwd_bytes(128, 192, False)) \
        == pytest.approx(0.0541, abs=1e-4)
    assert record_ms(fl.block_bwd_flops(128, 192), fl.block_bwd_bytes(128, 192)) \
        == pytest.approx(0.1082, abs=1e-4)
    assert fl.block_params() == 49_984  # 2 LayerNorms, Q/K/V/O, the FFN


@pytest.mark.parametrize("hidden,d,fwd_ms,bwd_ms", [
    (128, 2, 0.0962, 0.1923), (4, 2, 0.0012, 0.0026), (128, 1, 0.0481, 0.0962),
    (256, 2, 0.3846, 0.7692), (512, 2, 1.5385, 3.0770), (1024, 1, 3.0770, 6.1540)])
def test_lstm_bounds_match_the_record(hidden, d, fwd_ms, bwd_ms):
    t, b = 192, 128
    got_fwd = record_ms(fl.lstm_fwd_flops(t, d, b, hidden), fl.lstm_fwd_bytes(t, d, b, hidden,
                                                                              False))
    got_bwd = record_ms(fl.lstm_bwd_flops(t, d, b, hidden), fl.lstm_bwd_bytes(t, d, b, hidden))
    assert got_fwd == pytest.approx(fwd_ms, abs=1e-4)
    assert got_bwd == pytest.approx(bwd_ms, abs=1e-4)


def test_bound_takes_the_precision_peak():
    assert fl.bound_s(495e12, 0, "float32") == pytest.approx(1.0)
    assert fl.bound_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert fl.bound_s(0, 3.35e12, "float32") == pytest.approx(1.0)


def test_training_saves_cost_bytes():
    assert fl.block_fwd_bytes(128, 192, True) > fl.block_fwd_bytes(128, 192, False)
    assert fl.lstm_fwd_bytes(192, 2, 128, 128, True) > fl.lstm_fwd_bytes(192, 2, 128, 128, False)


def test_flagship_totals():
    t = 192
    conv64 = 2 * t * 64 * 64 * 64
    eeg = 2 * t * 64 * 64 + 10 * (conv64 + fl.block_fwd_flops(1, t)) + 2 * t * 64 * 8
    assert flagship_flops.eeg_flops_per_window() == pytest.approx(eeg)
    assert eeg == pytest.approx(1.2915e9, rel=1e-4)
    speech = (2 * t * 1024 * 64, 2 * t * 64 * 64 * 32,
              2 * (2 * t * 64 * 512 + 2 * t * 128 * 512), 2 * (2 * t * 256 * 16 + 2 * t * 4 * 16))
    heads = 2 * 2 * 128 * t * 8
    first = 2 * t * 64 * 64 + speech[0]
    step = 128 * (3 * (eeg + sum(speech) + heads) - first)
    assert flagship_flops.train_flops_per_pair(128) * 128 == pytest.approx(step)
    assert step == pytest.approx(0.552e12, rel=1e-3)


def test_double_lstm_totals():
    t, h = 192, 128
    enc = [2 * t * c * 128 + 2 * t * 128 * 4 * h + 2 * t * h * 4 * h + 2 * (2 * t * h * 4 * h)
           for c in (64, 1024)]
    assert double_lstm_flops.eeg_flops_per_window() == pytest.approx(enc[0])
    heads = 3 * (2 * t * h * 16 + 2 * 16 * 8) + 2 * 128 * 8
    first = 2 * t * 64 * 128 + 2 * t * 1024 * 128
    step = 128 * (3 * (sum(enc) + heads) - first)
    assert double_lstm_flops.train_flops_per_pair(128) * 128 == pytest.approx(step)
