"""The port's dry run (`repro_torch.launch.dryrun`) on the meta device.

One subprocess (the dry run starts a `fake` process group of its mesh's
ranks, which must not outlive it) builds the cells and hands the results
back as JSON: the reference's accounting check
(`tests/test_distributed.py::test_dryrun_tiny_cell_scan2_matches_unroll`)
on the meta device, a 4-layer tinyllama at d_model 128 on (2, 2, 2)
("pod", "data", "model"), where `scan2` (depth 1 and 2, extrapolated)
must hold the FLOPs within 5 % and the collective bytes within 15 % of
`unroll` (full depth); one cell of each family on the (16, 16) production
mesh; and the command line on the tiny mesh.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.config import MeshConfig, SINGLE_POD_MESH, ShardingPlan  # noqa: E402
from repro_torch.launch import partitioning as parts  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
#: one cell of each family on (16, 16): dense, MoE, VLM, SSM, hybrid and
#: the encoder-decoder (its training step: frames, cross-attention)
FAMILY_CELLS = (("tinyllama-1.1b", "decode_32k"),
                ("phi3.5-moe-42b-a6.6b", "decode_32k"),
                ("chameleon-34b", "decode_32k"),
                ("falcon-mamba-7b", "decode_32k"),
                ("zamba2-2.7b", "decode_32k"),
                ("whisper-tiny", "train_4k"))

BODY = """
import dataclasses, json, sys
from repro_torch.config import ArchSpec, MeshConfig, SINGLE_POD_MESH, \\
    ShapeConfig, ShardingPlan, SHAPES_BY_NAME
from repro_torch.configs import REGISTRY, get_arch
from repro_torch.launch import dryrun as dr

out = {"tiny": {}, "cells": {}}
base = get_arch("tinyllama-1.1b")
small = dataclasses.replace(base.model, n_layers=4, d_model=128, n_heads=4,
                            n_kv_heads=2, head_dim=32, d_ff=256, vocab=512,
                            attn_chunk=64)
REGISTRY["tiny-test"] = ArchSpec("tiny-test", small, base.smoke)
mesh = dr.fake_mesh(MeshConfig((2, 2, 2), ("pod", "data", "model")))
shape = ShapeConfig("t", seq_len=256, global_batch=8, kind="train")
for mode in ("scan2", "unroll"):
    out["tiny"][mode] = dr.analyze_cell("tiny-test", shape, mesh, "tiny",
                                        ShardingPlan(), mode=mode)
mesh = dr.fake_mesh(SINGLE_POD_MESH)
for arch, name in %r:
    out["cells"][arch] = dr.analyze_cell(arch, SHAPES_BY_NAME[name], mesh,
                                         "single_pod_16x16",
                                         ShardingPlan(grad_sharding="zero1"))
out["rc"] = dr.main(["--mesh", "tiny", "--arch", "whisper-tiny",
                     "--shape", "decode_32k", "long_500k",
                     "--out", sys.argv[2]])
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
""" % (FAMILY_CELLS,)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(BODY), str(tmp / "out.json"),
         str(tmp / "cli")], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-6000:])
    return json.loads((tmp / "out.json").read_text()), tmp / "cli", \
        proc.stdout


def test_scan2_matches_unroll_on_the_tiny_cell(runs):
    """scan2's per-layer extrapolation against a full build of 4 layers:
    FLOPs within 5 %, collective bytes within 15 % (the reference's
    check); the arguments are the full depth's either way."""
    out, _, _ = runs
    r2, ru = out["tiny"]["scan2"], out["tiny"]["unroll"]
    f2, fu = r2["flops_per_device"], ru["flops_per_device"]
    assert fu > 0 and abs(f2 - fu) / fu < 0.05, (f2, fu)
    c2 = r2["collectives"]["total_bytes"]
    cu = ru["collectives"]["total_bytes"]
    assert cu > 0 and abs(c2 - cu) / cu < 0.15, (c2, cu)
    assert r2["memory"]["argument_bytes"] == ru["memory"]["argument_bytes"]
    assert r2["n_chips"] == 8 and r2["mesh_shape"] == [2, 2, 2]
    # zero1 on ("pod", "data"): a reduce-scatter and an all-gather a
    # replica axis
    for kind in ("reduce-scatter", "all-gather"):
        assert ru["collectives"]["counts"][kind] == 2


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_one_cell_of_each_family_on_the_production_mesh(runs, arch, shape):
    """Each family builds on rank 0 of the (16, 16) mesh under a fake group
    of 256 ranks: FLOPs (matrix products, said so in the JSON), bytes and
    all-reduces counted, the roofline terms against the H100 SXM's data
    sheet, the dominant term one of them; the parameter bytes are exactly
    this rank's blocks (`local_param_shapes`), at bf16 to serve and f32 to
    train, and a training cell counts zero1's reduce-scatter and
    all-gather."""
    out, _, _ = runs
    r = out["cells"][arch]
    assert r["n_chips"] == 256 and r["mesh_shape"] == [16, 16]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert "matrix products only" in r["flops_counts"]
    assert r["collectives"]["counts"]["all-reduce"] > 0
    assert set(r["terms_s"]) == {"compute", "memory", "collective"}
    assert r["dominant"] in r["terms_s"]
    assert "floor" in r["hardware"]["note"]
    assert r["hardware"]["nvlink_bw"] == 900e9
    cfg = get_arch(arch).model
    serve = shape != "train_4k"
    plan = ShardingPlan(grad_sharding="zero1")
    shapes = parts.local_param_shapes(cfg, SINGLE_POD_MESH, plan)
    f32 = ("dt_bias", "a_log", "d_skip", "router")
    want = sum(
        torch.Size(s).numel() * (4 if k.rsplit(".", 1)[-1] in f32 or not serve
                                 else 2) for k, s in shapes.items())
    assert r["memory"]["argument_bytes"]["params"] == want
    if not serve:
        assert r["collectives"]["counts"]["reduce-scatter"] == 1
        assert r["collectives"]["counts"]["all-gather"] >= 1
        assert r["memory"]["argument_bytes"]["opt_state"] > 0
    else:
        assert r["memory"]["argument_bytes"]["cache"] > 0
    assert r["memory"]["temp_peak_bytes"] is None or \
        r["memory"]["temp_peak_bytes"] > 0


def test_command_line_writes_one_json_a_cell(runs):
    """`main` on the tiny mesh: a JSON per cell it builds and a summary,
    the cells `ArchSpec.cells()` rules out skipped with the reason
    (whisper's full attention at 512k), exit code 0."""
    out, cli, stdout = runs
    assert out["rc"] == 0
    cell = cli / "tiny_2x2x2__whisper-tiny__decode_32k__zero1.json"
    assert json.loads(cell.read_text())["status"] == "ok"
    summary = json.loads((cli / "summary_tiny_zero1.json").read_text())
    assert [s["status"] for s in summary] == ["ok", "skip"]
    assert "[dryrun] ok=1 skip=1 fail=0" in stdout
    assert MeshConfig((2, 2, 2), ("pod", "data", "model")).n_devices == 8
