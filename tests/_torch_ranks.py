"""Run a function in N CPU ranks of one gloo process group.

Each rank is its own ``python`` process (no port: the ranks meet through a
``file://`` store under the test's ``tmp_path``). The test waits for all of
them under one time limit, so a hung rendezvous fails the test instead of
stalling the suite, and every rank is killed on the way out.

    results = run_ranks(tmp_path, "_torch_rank_bodies:collectives", 4)

``target`` names ``module:function``; the function is called as
``fn(rank, world, **kwargs)`` in every rank after the default process group
is up, and returns a picklable result (numpy arrays, numbers). The list of
the ranks' results comes back in rank order.
"""
from __future__ import annotations

import importlib
import os
import pathlib
import pickle
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
RANK_TIMEOUT_S = 120


def run_ranks(tmp_path, target: str, world: int, **kwargs) -> list:
    import pytest

    work = pathlib.Path(tmp_path) / target.replace(":", "_")
    work.mkdir(parents=True, exist_ok=True)
    (work / "kwargs.pkl").write_bytes(pickle.dumps(kwargs))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC), str(HERE)] + ([env["PYTHONPATH"]]
                                 if env.get("PYTHONPATH") else []))
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, target, str(rank), str(world), str(work)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        outs = []
        for rank, p in enumerate(procs):
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"{target}: rank {rank} of {world} did not end "
                            f"within {RANK_TIMEOUT_S} s")
            outs.append(out.decode(errors="replace"))
            if p.returncode != 0:
                pytest.fail(f"{target}: rank {rank} exited with "
                            f"{p.returncode}:\n{outs[-1][-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [pickle.loads((work / f"result_{rank}.pkl").read_bytes())
            for rank in range(world)]


def _rank_main(target: str, rank: int, world: int, work: str) -> None:
    import torch.distributed as dist

    kwargs = pickle.loads((pathlib.Path(work) / "kwargs.pkl").read_bytes())
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=world)
    module, name = target.split(":")
    result = getattr(importlib.import_module(module), name)(
        rank, world, **kwargs)
    (pathlib.Path(work) / f"result_{rank}.pkl").write_bytes(
        pickle.dumps(result))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
