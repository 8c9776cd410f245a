"""The copy of the model-FLOP arithmetic reads the repository's numbers."""

import pytest

from benchmark import flops

D256 = [512, 512, 512, 512, 256, 128, 64]
D1024 = D256 + [32, 16]


@pytest.mark.parametrize("depths, scale, r1_interval, tflop", [
    (D256, 6, 1, 13.51004708864),        # pggan256.train_r1
    (D256, 6, 16, 10.97691147776),       # pggan256.train_lazy_r1
    (D1024, 8, 1, 20.49507319808),       # pggan1024.train_r1
])
def test_step_model_tflops(depths, scale, r1_interval, tflop):
    got = flops.step_model_tflops(depths, scale, 16, 512, "r1", r1_interval)
    assert got == pytest.approx(tflop, rel=1e-12)


def test_g_forward_flops_at_256():
    assert flops.g_forward_flops(D256, 6, 16, 512) / 1e12 == pytest.approx(0.900668063744,
                                                                           rel=1e-12)


def test_wgangp_passes():
    assert flops.d_passes("wgangp") == 14.0 and flops.d_passes("r1", 16) == 131.0 / 16
