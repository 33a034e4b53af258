"""The operations and bytes the yardstick counts, pinned to a hand count."""

import pytest
import torch

from portbench import harness, work

MODEL = harness.load_config(harness.load_spec(), "clair2-f32")["model"]
ROWS = 10_000 * 33


def test_forward_flops_per_row():
    # 2 per multiply-add: lstm1 2 directions x 33 steps x (32 + 128) x 512,
    # lstm2 the same with 256 inputs, L3 33 x 256 x 30, L4 7,680 x 192, four
    # stems 192 x 96, the heads 96 x (21 + 3 + 33 + 33)
    assert work.forward_flops_per_row(MODEL) == {
        "lstm1": 10_813_440, "lstm2": 25_952_256, "l3": 506_880, "l4": 2_949_120,
        "stems": 147_456, "heads": 17_280}
    assert sum(work.forward_flops_per_row(MODEL).values()) == 40_386_432


def test_model_flops_counts_three_forwards_a_training_row():
    assert work.model_flops(MODEL, 10_000, 0) == 3 * 40_386_432 * 10_000
    assert work.model_flops(MODEL, 0, 512) == 40_386_432 * 512


@pytest.mark.parametrize("dtype,e", [("bfloat16", 2), ("float32", 4)])
def test_row_1_work(dtype, e):
    (f1, b1), (f2, b2) = work.train_forward_work(MODEL, 10_000, dtype)
    assert f1 == 4 * ROWS * (32 + 128) * 512 == 108_134_400_000
    assert f2 == 4 * ROWS * (256 + 128) * 512 == 259_522_560_000
    weights = lambda feat: 2 * (feat + 128) * 512 * e + 2 * 512 * 4
    out = ROWS * 256 * (e + 4)
    assert b1 == ROWS * 32 * e + weights(32) + out
    assert b2 == ROWS * 256 * e + weights(256) + out


@pytest.mark.parametrize("dtype,e", [("bfloat16", 2), ("float32", 4)])
def test_row_2_work(dtype, e):
    (f1, b1), (f2, b2) = work.train_backward_work(MODEL, 10_000, dtype)
    assert f1 == 4 * ROWS * 512 * (160 + 128 + 160) == 302_776_320_000
    assert f2 == 4 * ROWS * 512 * (384 + 128 + 384 + 256) == 778_567_680_000
    weights = lambda feat: 2 * (feat + 128) * 512 * e + 2 * 512 * 4
    saved = ROWS * 256 * (e + 4 + e)
    grads = lambda feat: 2 * (feat + 128 + 1) * 512 * 4
    assert b1 == ROWS * 32 * e + weights(32) + saved + grads(32)
    assert b2 == 2 * ROWS * 256 * e + weights(256) + saved + grads(256)


def test_rooflines_take_the_bf16_peak_in_both_dtypes():
    for dtype in ("bfloat16", "float32"):
        flops = sum(f for f, _ in work.train_backward_work(MODEL, 10_000, dtype))
        assert work.roofline_ms(work.train_backward_work(MODEL, 10_000, dtype)) >= (
            flops / 989e12 * 1e3)
    # the kernel table's bound of row 2 bf16 (phase 9d): 1.0934 ms
    assert work.roofline_ms(work.train_backward_work(MODEL, 10_000, "bfloat16")) == (
        pytest.approx(1.0934, abs=1e-4))
    assert work.PEAK_BF16_FLOPS == 989e12 and work.HBM_BYTES_PER_S == 3.35e12


def test_counts_refuse_widths_they_do_not_describe():
    with pytest.raises(ValueError):
        work.train_forward_work(dict(MODEL, lstm2_num_units=256), 10_000, "bfloat16")
