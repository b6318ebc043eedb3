"""The harness's seam by model family: the committed cells' work read
through the ``unet`` family exactly as before the seam, every step of a run
and of the control's readings going through the family (a counting stub
family in ``tests/families/``), the functions of a run naming no network of
a family, a family with no file refused when its cell is loaded, and a
family file with a dataclass loading."""

from __future__ import annotations

import inspect
import json
import re

import pytest
import torch
from bench_tiny import BENCH, run_tiny, tiny_cell

from benchmark import control, harness
from benchmark import trace as T

# (FLOPs of one sample, attention bound in s, kinds of attention call) at
# the published widths, read on the meta device before the seam
WORK = {
    "sd15-512-footnote": (209930257911808, 0.03219316769503343, 9),
    "sdxl-1024-footnote-inject": (1711583369539584, 0.18999476157735085, 5),
    "sd15-512-color": (468163696218112, 0.03219316769503343, 9),
}


@pytest.mark.parametrize("cell", sorted(WORK))
def test_the_work_of_each_cell_through_its_family(cell):
    c = harness.load_cell(cell)
    fam = harness.family(c["cfg"])
    assert fam is harness.load_module(BENCH / "families" / "unet.py")
    fl, bound, calls = fam.work(c["cfg"], c["traffic"])
    assert (fl, bound, len(calls)) == WORK[cell]


def test_every_step_goes_through_the_family(monkeypatch):
    monkeypatch.setattr(harness, "FAMILIES", BENCH / "tests" / "families")
    cell = tiny_cell("footnote")
    cell["cfg"]["family"] = "stub"
    stub = harness.family(cell["cfg"])
    stub.CALLS.clear()
    # a traced run on the CPU: the profiler traces the host alone and there
    # is no card to wait for
    profiled = T.profiled
    monkeypatch.setattr(T, "profiled",
                        lambda fn, cpu=True: profiled(fn, cpu=True))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rc, res = run_tiny(cell, trace=1)
    assert rc == 0 and res is not None
    assert res["correct"], res["checks"]
    # the weights twice: for the program, then for the reference
    assert stub.CALLS == {
        "draw_state": 2, "build_model": 1, "recorder": 1, "spans": 1,
        "work": 1, "checked": 1, "reference": 1, "evaluate": 1,
        "subject_of": 1, "compare": 1}
    stub.CALLS.clear()
    line = control.readings(cell, 7, torch.device("cpu"), True)
    assert set(line) >= {"program", "control"}
    assert stub.CALLS == {
        "draw_state": 2, "build_model": 1, "recorder": 1, "checked": 1,
        "reference": 1, "control": 1, "evaluate": 2, "subject_of": 1,
        "compare": 2}


@pytest.mark.parametrize("fn", [harness.run_cell, harness.trace_metrics,
                                harness.check, control.record_one,
                                control.readings],
                         ids=lambda f: f.__name__)
def test_the_steps_of_a_run_name_no_network(fn):
    src = inspect.getsource(fn)
    found = re.findall(r"UNet|CLIPText|RegionDiffusion|port_configs|"
                       r"\[\"model\"\]|(?<!fam\.)\b(?:Recorder|Spans|Reference"
                       r"|draw_state|build_model|sample_inputs)\(", src)
    assert not found, found


def test_a_family_without_a_file_is_refused_with_the_cell(tmp_path,
                                                           monkeypatch):
    (tmp_path / "c.json").write_text(json.dumps({"name": "c",
                                                 "family": "nosuch"}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "c", "file": "c.json"}],
        "workloads": [{"name": "w", "config": "c", "traffic": "footnote",
                       "chips": 1}]}))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    with pytest.raises(SystemExit, match=r"families/nosuch\.py"):
        harness.load_cell("w")


def test_a_family_file_may_hold_a_dataclass(tmp_path, monkeypatch):
    (tmp_path / "dc.py").write_text(
        "from __future__ import annotations\nimport dataclasses\n\n\n"
        "@dataclasses.dataclass\nclass Shape:\n    width: int = 8\n")
    monkeypatch.setattr(harness, "FAMILIES", tmp_path)
    assert harness.family({"family": "dc"}).Shape().width == 8
