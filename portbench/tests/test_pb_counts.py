"""Operation, byte and MFU counts against numbers worked by hand for the
benchmark's two configurations (the decoder's model FLOPs,
``archs/decoder.py``, and the shared attention counts)."""
import json
from pathlib import Path

import pytest

from pbench import counts, spec
from pbench.cell import RunData

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
DECODER = spec.arch("decoder")


def port(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["port"]


PHI3, GRANITE = port("phi3-medium-14b"), port("granite-moe-1b-a400m")


def test_layer_weights():
    # phi3: attention 5120*40*128 + 2*5120*10*128 + 40*128*5120
    # = 26,214,400 + 13,107,200 + 26,214,400; FFN 3*5120*17920
    assert DECODER.layer_weights_active(PHI3) == 65_536_000 + 275_251_200
    # granite: attention 1024*16*64*2 + 2*1024*8*64 = 3,145,728;
    # router 1024*32; 8 of 32 experts of 3*1024*512
    assert DECODER.layer_weights_active(GRANITE) == (
        3_145_728 + 32_768 + 8 * 1_572_864)


def test_prefill_flops_phi3():
    S = 1000
    want = (2 * S * 40 * 340_787_200          # layers
            + 2 * 5120 * 32064                # head at the last position
            + 40 * 2 * 40 * 128 * S * (S + 1))  # causal QK^T and PV
    assert DECODER.prefill_flops(PHI3, S) == pytest.approx(want)
    # 27.9 TFLOP for a 1000-token prompt: 2 x 13.6 B x tokens plus attention
    assert DECODER.prefill_flops(PHI3, S) == pytest.approx(2.7683e13,
                                                          rel=1e-3)


def test_decode_flops_granite():
    want = 2 * 100 * (24 * 15_761_408 + 1024 * 49155) + 24 * 4 * 16 * 64 * 9000
    assert DECODER.decode_flops(GRANITE, 100, 9000) == pytest.approx(want)


def test_attention_bounds():
    # flash, phi3, S = 2048: 2*40*128*2048*2049 FLOPs = 42.97 GFLOP ->
    # 43.4 us at 989 TFLOP/s; bytes 2*2048*128*(80+20) = 52.4 MB -> 15.6 us
    f = counts.attn_prefill_flops(PHI3, 2048)
    b = counts.attn_prefill_bytes(PHI3, 2048)
    assert f == 2 * 40 * 128 * 2048 * 2049
    assert b == 2 * 2048 * 128 * 100
    assert counts.bound_s(f, b) == pytest.approx(f / 989e12)
    # paged decode, granite, 256 rows attending 20,000 positions in all:
    # 4*16*64*20000 FLOPs; bytes 2*64*(2*256*16 + 2*20000*8) -> bytes bind
    f = counts.attn_decode_flops(GRANITE, 20000)
    b = counts.attn_decode_bytes(GRANITE, 256, 20000)
    assert b == 2 * 64 * (8192 + 320000)
    assert counts.bound_s(f, b) == pytest.approx(b / 3.35e12)


def test_mfu_reader():
    fn, variant = spec.reader("model.mfu.prefill")
    run = RunData(p=PHI3, arch=DECODER, w0=0.0, w1=10.0, stamps=[],
                  decodes=[],
                  prefills=[(1.0, 0.1, 1000, 0), (2.0, 0.1, 1000, 0)])
    # 2 x 27.683 TFLOP in 0.2 s at 989 TFLOP/s
    assert fn(run, variant) == pytest.approx(
        100 * 2 * DECODER.prefill_flops(PHI3, 1000) / (0.2 * 989e12))
    assert fn(run, variant) < 100
