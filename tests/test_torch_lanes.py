"""Rehearsals on the CPU of the port's benchmark lanes and tools that run
on the card: ``bench_gpu.py`` ``--shards``, ``--turek2d``,
``--turek2d-adaptive`` and ``--all``, ``bench_step_gpu.py`` and
``tools/step_configs_gpu.py``.  Each runs its control flow with
``--device cpu`` (the plain versions of the kernels) at a small size and
prints no device metric."""

import json
import os
import sys

import pytest
import torch
from ns_gls_tpu_torch.utils.device import torch_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


def _import(name, sub=""):
    path = os.path.join(ROOT, sub)
    sys.path.insert(0, path)
    try:
        return __import__(name)
    finally:
        sys.path.remove(path)


def _rehearse(main, argv, capsys, expect):
    assert main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert expect in out, out
    assert "not measured" in out and "MDoF/s" not in out
    return out


@pytest.mark.parametrize("argv,expect", [
    (["3", "2", "2", "--shards", "4"],
     "64 cells, degree 2, 2916 DoFs, fixed flavor, 4 shards"),
    (["2", "3", "1", "--increment", "--shards", "2"],
     "64 cells, degree 1, 243 DoFs, increment flavor, 2 shards"),
    (["--turek2d", "1"], "(turek2d): 352 cells, degree 2, 4572 DoFs"),
    (["--turek2d-adaptive", "1"],
     "(turek2d-adaptive): 556 cells, degree 2, 7146 DoFs"),
    (["3", "2", "2", "--all"], "64 cells, degree 2, 2916 DoFs, fixed"),
])
def test_bench_gpu_lane_rehearsal(argv, expect, capsys):
    bench_gpu = _import("bench_gpu")
    _rehearse(bench_gpu.main, argv, capsys, expect)


def test_bench_gpu_lane_options(capsys):
    """The lanes' operators: the Turek 2D lane on the patch-2D sweep (the
    adaptive one on several patch families) and on the general sweep by
    the operator's own argument; ``--shards`` refuses what it does not
    run."""
    from ns_gls_tpu_torch.ops.patch2d import Patch2DSweep

    bench_gpu = _import("bench_gpu")
    op, _, u = bench_gpu.build_turek2d(1, 2, False, "cpu")
    assert isinstance(op._fast, Patch2DSweep) and len(
        op._fast.tables.fams) == 1
    og, _, ug = bench_gpu.build_turek2d(1, 2, False, "cpu",
                                        use_structured=False)
    assert og._fast is None and torch.equal(u, ug)
    assert torch.allclose(og.vmult(u), op.vmult(u), rtol=1e-4, atol=1e-3)
    oa, _, _ = bench_gpu.build_turek2d(1, 2, True, "cpu")
    assert len(oa._fast.tables.fams) > 1
    for argv in (["3", "2", "2", "--batched", "--shards", "2"],
                 ["3", "2", "2", "--all", "--increment"],
                 ["--turek2d", "--shards", "2"]):
        with pytest.raises(SystemExit) as exc:
            bench_gpu.main(argv + ["--device", "cpu"])
        assert exc.value.code == 2
    capsys.readouterr()


def test_bench_step_gpu_rehearsal(capsys):
    """``bench_step_gpu.py`` through the port's driver: Turek 2D at
    refinement 0 for one warm-up and one timed step (Turek 3D's first
    step takes minutes on the CPU)."""
    bench_step_gpu = _import("bench_step_gpu")
    assert bench_step_gpu.main(["0", "1", "--config", os.path.join(
        ROOT, "input", "turek_2d_re100.json"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert "not measured" in out[0]
    line = json.loads(out[-1])
    assert line["n_dofs"] == 1230 and line["config"] == \
        "input/turek_2d_re100.json"
    assert len(line["newton"]) == 2 and line["newton"][1] > 0
    assert "s_per_step" not in line


def test_step_configs_rehearsal(capsys, tmp_path):
    """``tools/step_configs_gpu.py`` on the smallest of its configs, one
    stationary solve at refinement 0, with its JSON line and file."""
    tool = _import("step_configs_gpu", "tools")
    out = tmp_path / "steps.jsonl"
    assert tool.main(["--configs", "turek_2d_re20_stationary",
                      "--refinements", "0", "--device", "cpu", "--out",
                      str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ok"] and line["stationary"] and line["newton"][0] > 0
    assert line["launches"] == {} and line["n_dofs"] == 1230
    assert json.loads(out.read_text()) == line
