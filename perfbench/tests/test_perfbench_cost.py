"""``cost.py`` pinned to the values PERF.md states and to the port's own
FLOPs count."""
import pathlib

import pytest

from perfbench import cost, inputs
from perfbench.reference import fold

VGG16 = 134_000_000


def test_vgg16_fold_wave_is_11_256_gb_and_3_360_ms():
    cuts = fold.uniform_cuts(VGG16, 4)
    nbytes, ops, secs = cost.wave_cost([(20, hi - lo, False)
                                        for lo, hi in cuts])
    assert nbytes == 84 * VGG16 == 11_256_000_000
    assert ops == 21 * VGG16
    assert secs * 1e3 == pytest.approx(3.360, abs=5e-4)


def test_lambda_fl_root_is_bytes_bound_in_f64():
    nbytes, ops, secs = cost.wave_cost([(4, VGG16, True)])
    assert nbytes == 20 * VGG16 and ops == 9 * VGG16
    assert secs == pytest.approx(nbytes / cost.HBM_BPS)


def test_tinyllama_fused_sgd_leaves_are_22_gb_and_6_567_ms():
    from repro_torch.configs import get_arch
    from repro_torch.models import registry
    n = registry.param_count(get_arch("tinyllama-1.1b").model)
    assert n * cost.FUSED_SGD_BYTES_PER_PARAM == pytest.approx(22.0e9,
                                                               rel=1e-3)
    assert cost.fused_sgd_bound_s(n) * 1e3 == pytest.approx(6.567, abs=5e-4)


def test_codec_bound_of_a_vgg16_shard_is_0_050_ms_each_way():
    shard = VGG16 // 4
    assert cost.codec_bound_s(shard) / 2 * 1e3 == pytest.approx(0.050,
                                                                abs=5e-4)


def test_gpt2_large_flops_are_the_ports_count():
    import dataclasses
    import json
    from repro_torch.config import ShapeConfig
    from repro_torch.configs.paper_workloads import GPT2_LARGE_MODEL
    from repro_torch.models import registry
    path = pathlib.Path(cost.__file__).parent / "configs" / "gpt2-large.json"
    cfg = json.loads(path.read_text())
    n = inputs.param_count(cfg)
    ours = cost.model_flops_train(n, 36, 20, 64, 4, 1024)
    tied = dataclasses.replace(GPT2_LARGE_MODEL, tie_embeddings=True)
    want = registry.model_flops(tied, ShapeConfig("t", 1024, 4, "train"))
    assert ours == pytest.approx(want, rel=1e-12)
    attn = 3 * 36 * 4 * 1024 * 20 * 64 * 0.5      # a token, causal
    assert ours / 4096 == pytest.approx(6 * n + attn, rel=1e-12)
    assert ours == pytest.approx(2.014e13, rel=5e-3)
