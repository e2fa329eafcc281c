"""``chip_smoke.py``'s phase clock (``clocked``: where the script's wall time
goes), ``tools/torch_smoke_phases.py``, which puts the same clock round
the phases of a tree's script from before the clock, and the kernel
build's report of each source's compile seconds. CPU only: both files are
loaded by path, as the tools load ``chip_smoke.py``; the build runs a
stand-in for ``nvcc``."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

import pytest

from lifelong_clip_tpu_torch.ops import _kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke_clock_test", "chip_smoke.py")
phases = _load("torch_smoke_phases", os.path.join("tools",
                                                  "torch_smoke_phases.py"))


@pytest.fixture
def clock(monkeypatch):
    monkeypatch.setattr(cs, "PHASE_WALL_S", {})
    monkeypatch.setattr(cs, "CASE_WALL_S", {})
    return cs


def test_outermost_calls_only(clock):
    """A clocked phase that calls another clocked function counts once,
    under its own name; each call adds to the sum."""
    @clock.clocked
    def inner_phase():
        time.sleep(0.01)

    @clock.clocked
    def outer_phase():
        inner_phase()
        inner_phase()

    outer_phase()
    outer_phase()
    assert set(clock.PHASE_WALL_S) == {"outer_phase"}
    assert clock.PHASE_WALL_S["outer_phase"] >= 0.04
    inner_phase()
    assert 0.01 <= clock.PHASE_WALL_S["inner_phase"] < 0.04
    assert clock.CASE_WALL_S == {}


@pytest.mark.parametrize("call", ["positional", "keyword"])
def test_case_by_label(clock, call):
    """A ``*_case`` function's calls are summed under their label too, and
    an exception still stops the clock."""
    @clock.clocked
    def some_case(label, fail=False):
        if fail:
            raise ValueError(label)
        return label

    run = (lambda **k: some_case("ViT-L/14 vision", **k)) \
        if call == "positional" else \
        (lambda **k: some_case(label="ViT-L/14 vision", **k))
    assert run() == "ViT-L/14 vision"
    with pytest.raises(ValueError):
        run(fail=True)
    assert set(clock.CASE_WALL_S) == {"ViT-L/14 vision"}
    assert set(clock.PHASE_WALL_S) == {"some_case"}
    assert clock._CLOCK_DEPTH == [0]


def test_every_phase_of_main_is_clocked():
    """The tool clocks what the script clocks: every ``*_phase``, ``*_gate``
    and ``*_case`` function that ``main`` calls, the checkpoint phase and
    the gates included."""
    names = set(phases.clocked_names(os.path.join(ROOT, "chip_smoke.py")))
    called = set(inspect.getsource(cs.main).replace("(", " ").split())
    want = {n for n in dir(cs) if callable(getattr(cs, n))
            and n.endswith(("_phase", "_gate", "_case", "_cases"))
            and n in called}
    assert want and want <= names, want - names
    assert all(getattr(cs, n).__wrapped__ for n in names)


def test_tool_on_this_tree_without_a_card():
    """This tree's script clocks itself: the tool runs its ``main`` as it
    is, which without CUDA exits 2 and prints no result."""
    out = subprocess.run([sys.executable, os.path.join(
        ROOT, "tools", "torch_smoke_phases.py")], capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 2 and "no CUDA device" in out.stderr
    assert out.stdout.strip() == ""


FAKE_SCRIPT = """
import sys
from lifelong_clip_tpu_torch.ops import _kernels


def mesh_phase():
    return 1


def kernel_case(label):
    return label


def main():
    _kernels.build()
    mesh_phase()
    kernel_case("ViT-L/14 vision")
    print("ran", flush=True)
    return int(sys.argv[2])
"""


@pytest.mark.parametrize("rc", [0, 3])
def test_tool_clocks_a_tree_from_before_the_clock(tmp_path, rc):
    """A tree whose script has no clock: the tool wraps its kernel build
    and the phases this tree's script clocks, passes the script's output
    and exit code through and prints the clock after it."""
    ops = tmp_path / "lifelong_clip_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    for d in (ops.parent, ops):
        (d / "__init__.py").write_text("")
    (ops / "_kernels.py").write_text("def build():\n    return 'lib'\n")
    (tmp_path / "chip_smoke.py").write_text(FAKE_SCRIPT)
    out = subprocess.run([sys.executable, os.path.join(
        ROOT, "tools", "torch_smoke_phases.py"), str(tmp_path), str(rc)],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == rc, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "ran"
    got = json.loads(lines[-1])
    assert got["tree"] == str(tmp_path) and got["rc"] == rc
    assert set(got["phase_wall_s"]) == {"build", "mesh_phase",
                                        "kernel_case"}
    assert set(got["case_wall_s"]) == {"ViT-L/14 vision"}
    assert got["outside_the_phases_s"] >= 0


FAKE_NVCC = """import sys
args = sys.argv[1:]
open(args[args.index("-o") + 1], "w").close()
print("ptxas info    : stand-in")
"""


class _Python:
    """``subprocess`` for the build, each command run by this Python (the
    stand-in compiler is a script; no file under the test's temporary
    directory needs to be executable)."""
    PIPE, STDOUT = subprocess.PIPE, subprocess.STDOUT

    @staticmethod
    def Popen(cmd, **kw):
        return subprocess.Popen([sys.executable, *cmd], **kw)

    @staticmethod
    def run(cmd, **kw):
        return subprocess.run([sys.executable, *cmd], **kw)


def test_build_reports_each_source_compile_seconds(tmp_path, monkeypatch):
    """One compiler per source, all started together; the report beside
    the library carries each source's log under its compile seconds."""
    nvcc = tmp_path / "nvcc.py"
    nvcc.write_text(FAKE_NVCC)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_kernels, "subprocess", _Python)
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "build"))
    out = _kernels.build()
    assert os.path.exists(out) and out == _kernels.library_path()
    with open(out + ".ptxas.txt") as f:
        report = f.read()
    heads = [ln for ln in report.splitlines() if ln.startswith("== ")]
    assert [h.split()[1] for h in heads] == list(_kernels.SOURCES)
    for h in heads:
        assert h.endswith(" s)") and float(h.split("(")[1].split()[0]) >= 0
    assert report.count("ptxas info    : stand-in") == len(_kernels.SOURCES)
    assert _kernels.build() == out     # built: a no-op
